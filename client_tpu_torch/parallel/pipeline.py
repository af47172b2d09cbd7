"""GPipe pipeline parallelism over the mesh's ``pp`` dim.

Counterpart of client_tpu/parallel/pipeline.py.  The layer stack is split
into S contiguous stages; each rank along ``pp`` holds one stage's
parameters (stacked with a leading stage dim laid out over ``pp``).
Microbatches flow through the pipeline with ``collectives.ppermute``
activation handoffs: at step t, stage s processes microbatch t - s, so
after M + S - 1 steps all M microbatches have crossed all stages and the
bubble is the classic (S-1)/(M+S-1) fraction.

The schedule is JAX's, written as a Python loop each rank runs over its
own stage.  Backward differentiates straight through it (the permute's
backward is the reverse permute), which gives the full-batch gradients
with recomputation, as in JAX; the last stage's outputs reach every stage
through an all-reduce whose backward hands each stage the cotangent.
Inside the region the stage weights are replicated over every dim but
``pp``; the batch is split over ``batch_axis``, each of its ranks
pipelining its contiguous rows.
"""

import torch

from client_tpu_torch.parallel import collectives


def stack_stage_params(layers, n_stages):
    """[L] list of identical per-layer trees -> tree with leading [S, L/S]
    dims, ready to lay out over ``pp``."""
    from client_tpu_torch.parallel import tree_map

    n_layers = len(layers)
    if n_layers % n_stages:
        raise ValueError(
            f"{n_layers} layers not divisible by {n_stages} stages"
        )
    per = n_layers // n_stages
    stage_trees = [
        tree_map(lambda *xs: torch.stack(xs), *layers[s * per:(s + 1) * per])
        for s in range(n_stages)
    ]
    return tree_map(lambda *xs: torch.stack(xs), *stage_trees)


def stage_specs(stage_params, axis="pp"):
    """The stage dim of every leaf over ``axis`` (JAX's shard_map
    in_specs for the stage params)."""
    from client_tpu_torch.parallel import P, tree_map

    return tree_map(lambda _: P(axis), stage_params)


def pipeline_apply(stage_fn, stage_params, x, mesh, n_microbatches,
                   axis="pp", batch_axis="dp"):
    """Run ``x`` through the S-stage pipeline.

    Args:
      stage_fn: ``(stage_layers, x_mb) -> y_mb`` applying ONE stage's layer
        block to one microbatch; ``stage_layers`` leaves have a leading
        [L/S] dim.  Must preserve the microbatch shape.
      stage_params: tree from :func:`stack_stage_params`, leaves [S, L/S,
        ...]: DTensors laid out by :func:`stage_specs` (their gradients
        partial over ``batch_axis``), or plain tensors the same on every
        rank (each rank takes its stage, outside autograd).
      x: [B, ...] batch: a DTensor, or the same tensor on every rank.
      mesh: mesh containing ``axis``.
      batch_axis: mesh dim the batch splits over (data parallelism inside
        the pipeline region); None replicates it.

    Returns [B, ...] outputs as a DTensor: rows over ``batch_axis``,
    replicated elsewhere.
    """
    from torch.distributed.tensor import DTensor, Replicate, Shard

    names = mesh.mesh_dim_names
    n_stages = mesh.size(names.index(axis))
    stage = mesh.get_local_rank(axis)
    batch = x.shape[0]
    if batch % n_microbatches:
        raise ValueError(
            f"batch {batch} not divisible by {n_microbatches} microbatches"
        )
    n_batch = 1 if batch_axis is None else mesh.size(names.index(batch_axis))
    if n_batch > 1 and (batch // n_microbatches) % n_batch:
        raise ValueError(
            f"microbatch size {batch // n_microbatches} not divisible by "
            f"{batch_axis}={n_batch}"
        )
    if n_batch == 1:
        batch_axis = None
    rows = [Shard(0) if name == batch_axis else Replicate() for name in names]
    if isinstance(x, DTensor):
        x = x.redistribute(mesh, rows).to_local()
    elif batch_axis is not None:
        x = x.chunk(n_batch, 0)[mesh.get_local_rank(batch_axis)]
    local_params = _local_stage(stage_params, mesh, axis, batch_axis)
    group = mesh.get_group(axis)
    # x is replicated over pp: only stage 0 reads it, so its cotangent is
    # summed over the stages (the same on every one, as x's producer is)
    x = collectives.pbroadcast([x], (group,))[0]
    x_micro = x.reshape(n_microbatches, -1, *x.shape[1:])
    n_steps = n_microbatches + n_stages - 1
    state = torch.zeros_like(x_micro[0])  # the activation in flight
    if stage != 0:
        # x's all-reduce backward then follows this stage's permutes, as
        # it does on stage 0, where every feed reads x
        state = collectives.join(state, x)
    outputs = [torch.zeros_like(x_micro[0]) for _ in range(n_microbatches)]
    for t in range(n_steps):
        if stage == 0:
            # stage 0 ingests microbatch t (clamped: past-the-end steps
            # feed a stale microbatch whose output is never collected);
            # the join keeps the received activation's permute in this
            # rank's chain of collectives
            feed = x_micro[min(t, n_microbatches - 1)]
            current = collectives.join(feed, state)
        else:
            current = state
        y = stage_fn(local_params, current)
        # the last stage's step-t output is microbatch t-(S-1)
        out_idx = t - (n_stages - 1)
        if stage == n_stages - 1 and out_idx >= 0:
            outputs[out_idx] = y
        if t != n_steps - 1:  # the last handoff reaches no stage
            state = collectives.ppermute(y, group)
    # only the last stage holds real outputs (zeros elsewhere): the sum
    # over pp hands them to every stage.  The join puts this stage's chain
    # of permutes (through its last output) under the loss on every stage,
    # so each one's backward runs everywhere
    out = collectives.join(torch.stack(outputs), y)
    out = collectives.psum([out], (group,))[0]
    out = out.reshape(-1, *x.shape[1:])
    shape = torch.Size((batch, *x.shape[1:]))
    return DTensor.from_local(out, mesh, rows, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def _local_stage(stage_params, mesh, axis, batch_axis):
    """This rank's [L/S, ...] slice of every stage leaf
    (``parallel.local_shard``); its gradient is partial over
    ``batch_axis``."""
    from client_tpu_torch.parallel import P, local_shard, tree_map

    partial = () if batch_axis is None else (batch_axis,)
    return tree_map(
        lambda w: local_shard(w, mesh, P(axis), partial)[0], stage_params)
