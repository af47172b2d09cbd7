"""Vision models for the port's in-process server.

Counterpart of client_tpu/serve/models/vision.py: the small CNN
classifier (the hermetic stand-in for densenet_onnx / inception,
BASELINE.md configs 1-2), the bottleneck ResNet-50 of BASELINE.md config
3, and the three-step vision pipeline (preprocess -> ResNet backbone ->
classification head) whose intermediates stay on the device.  Parameters
live on the device in bfloat16, with float32 I/O at the protocol boundary.
Convolutions, pooling and the head are PyTorch library calls (cuDNN and
cuBLAS on the card), as they are XLA ops outside any Pallas kernel in the
reference.  On a CUDA device the activations run ``channels_last``; the
wire spec stays NCHW.

Served through the dynamic batcher (serve/dynamic_batcher.py), each
padded bucket's forward is one CUDA graph on the card.  The pipeline's
three steps run through programs of their own (:class:`_StepPrograms`,
the port's ``jax.jit`` of each step): one CUDA graph per input shape and
dtype, captured at its first sight.

Parameters are drawn from an explicit ``torch.Generator`` on the CPU and
then moved, so a seed gives the same weights on every device.  The draws
are not JAX's; the tests carry the JAX parameters across instead.
"""

import threading

import numpy as np
import torch
import torch.nn.functional as F

from client_tpu_torch import resolve_device
from client_tpu_torch.serve.dynamic_batcher import (
    _BucketProgram, device_stream)
from client_tpu_torch.serve.model_runtime import Model, TensorSpec

# ImageNet-ish class count so classification extension demos look real.
_NUM_CLASSES = 1000


def _same_pads(size, k, stride):
    """XLA's ``"SAME"`` padding of one spatial dim: (lo, hi).  At stride 2
    it is asymmetric (more at the end), which torch's symmetric
    ``padding=`` cannot express: the stem 7x7/2 at 224 needs (2, 3), a
    3x3/2 at an even size (0, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _promote(*tensors):
    """The tensors in their common type (float32 parameters under a
    bf16 activation compute in float32)."""
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in tensors]


def _conv(x, w, stride=1):
    """NCHW x OIHW conv with XLA's SAME padding (JAX ``_conv``)."""
    x, w = _promote(x, w)
    top, bottom = _same_pads(x.shape[2], w.shape[2], stride)
    left, right = _same_pads(x.shape[3], w.shape[3], stride)
    if top == bottom and left == right:
        return F.conv2d(x, w, stride=stride, padding=(top, left))
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)


def _max_pool(x):
    """3x3/2 max-pool with SAME padding of -inf (JAX's ``reduce_window``
    with a -inf init)."""
    top, bottom = _same_pads(x.shape[2], 3, 2)
    left, right = _same_pads(x.shape[3], 3, 2)
    x = F.pad(x, (left, right, top, bottom), value=float("-inf"))
    return F.max_pool2d(x, 3, 2)


def _mean_hw(h):
    # global average pool: both frameworks sum a bf16 tensor in float32
    # and return bf16
    return h.mean(dim=(2, 3))


def _matmul(a, b):
    a, b = _promote(a, b)
    return a @ b


def _compute_input(x):
    """The float32 image as the bf16 activation the first conv reads;
    channels_last on a CUDA device (cuDNN's tensor-core layout)."""
    h = x.to(torch.bfloat16)
    if h.is_cuda:
        h = h.contiguous(memory_format=torch.channels_last)
    return h


def _place(tree, device):
    """A parameter tree on *device*; 4-D conv weights channels_last on
    CUDA."""
    if isinstance(tree, dict):
        return {k: _place(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_place(v, device) for v in tree]
    if device.type == "cuda" and tree.dim() == 4:
        return tree.to(device, memory_format=torch.channels_last)
    return tree.to(device)


def _normal(gen, shape, scale):
    # drawn in float32 then rounded, as JAX draws bf16 normals and scales
    # them in bf16 (the weights differ anyway: other generator)
    return (torch.randn(shape, generator=gen) * scale).to(torch.bfloat16)


def _init_cnn_params(gen, channels=(32, 64, 128, 256), in_ch=3,
                     num_classes=_NUM_CLASSES):
    params = {"convs": [], "scales": []}
    prev = in_ch
    for ch in channels:
        params["convs"].append(
            _normal(gen, (ch, prev, 3, 3), 2.0 / np.sqrt(prev * 9)))
        params["scales"].append(torch.ones((ch, 1, 1), dtype=torch.bfloat16))
        prev = ch
    params["head"] = _normal(gen, (prev, num_classes), 1.0 / np.sqrt(prev))
    return params


@torch.no_grad()
def _cnn_forward(params, x):
    # x: [N, 3, H, W] float32 -> scores [N, num_classes] float32
    h = _compute_input(x)
    for w, s in zip(params["convs"], params["scales"]):
        # the CNN rescales after the ReLU (ResNet before it)
        h = F.relu(_conv(h, w, stride=2)) * s
    h = _mean_hw(h)
    return _matmul(h, params["head"]).float()


def _conv_flops(out_ch, in_ch, kh, kw, out_h, out_w):
    # one MAC = 2 FLOPs; elementwise (relu/scale/add) is noise next to this
    return 2 * out_ch * in_ch * kh * kw * out_h * out_w


def cnn_flops_per_image(image_size=224, channels=(32, 64, 128, 256),
                        in_ch=3, num_classes=_NUM_CLASSES):
    """Analytic forward FLOPs for one image through the small CNN."""
    flops, hw, prev = 0, image_size, in_ch
    for ch in channels:
        hw = (hw + 1) // 2  # stride-2 SAME conv
        flops += _conv_flops(ch, prev, 3, 3, hw, hw)
        prev = ch
    return flops + 2 * prev * num_classes


def _as_device_tensor(arr, device):
    """A request's input on the model's device: host arrays are copied
    in; a tensor must already be there (an ensemble handoff)."""
    if isinstance(arr, torch.Tensor):
        if arr.device.type != device.type or (
                device.index is not None and arr.device.index != device.index):
            raise RuntimeError(
                f"input tensor on {arr.device}, model on {device}")
        return arr
    # a wire tensor is a read-only view of the request body: torch needs a
    # writable array, so that one is copied
    return torch.from_numpy(np.require(arr, requirements=["C", "W"])).to(
        device)


class CnnClassifier:
    """CNN classifier servable on *device* (``cuda`` unless the caller
    says otherwise); accepts any batch of RGB images."""

    def __init__(self, seed=0, device=None):
        self.device = resolve_device(device)
        self.params = _place(
            _init_cnn_params(torch.Generator().manual_seed(seed)),
            self.device)

    def __call__(self, inputs, params, ctx):
        # the output stays a device tensor; the runtime copies it to the
        # host only to render a wire response
        x = _as_device_tensor(inputs["INPUT0"], self.device)
        return {"OUTPUT0": _cnn_forward(self.params, x)}


def cnn_classifier_model(name="cnn_classifier", image_size=224,
                         max_batch_size=64, warmup=False, device=None):
    """Servable Model wrapping CnnClassifier (densenet_onnx stand-in).

    Dynamic batching is on: concurrent wire requests fuse into one padded
    batched forward (one H2D, one forward, one D2H per batch), each
    bucket's forward a CUDA graph on the card."""
    runner = CnnClassifier(device=device)
    labels = [f"class_{i}" for i in range(_NUM_CLASSES)]
    return Model(
        name,
        inputs=[TensorSpec("INPUT0", "FP32", [-1, 3, image_size, image_size])],
        outputs=[TensorSpec("OUTPUT0", "FP32", [-1, _NUM_CLASSES],
                            labels=labels)],
        fn=runner,
        platform="torch",
        backend="torch",
        device=runner.device,
        max_batch_size=max_batch_size,
        dynamic_batching=True,
        warmup=warmup,
        batch_device_inputs=True,
        fused_batching=True,
        max_fused_arity=16,
        flops_per_item=cnn_flops_per_image(image_size),
    )


# ---------------------------------------------------------------------------
# ResNet-50 (BASELINE.md config 3: perf_analyzer concurrency sweep on
# resnet50 with inputs in device memory).  Real bottleneck residual blocks
# at the standard [3,4,6,3] depth: 4.09 GMACs = ~8.2 GFLOP per 224x224
# image (the commonly cited "4.1 GFLOPs" counts MACs), so a throughput
# number on this model is a compute statement (MFU), not a protocol
# statement.  Inference-only: batch norm folds into the per-channel scales
# (s1..s3, stem_scale) at serving time.
# ---------------------------------------------------------------------------

# Single source of stage geometry: (mid_channels, n_blocks, first_stride)
# per stage.  _init_resnet_params, _resnet_forward and
# resnet50_flops_per_image all derive from this.
_RESNET50_STAGES = ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2))


def _he(gen, shape, fan_in):
    return _normal(gen, shape, np.sqrt(2.0 / fan_in))


def _init_resnet_params(gen, in_ch=3, num_classes=_NUM_CLASSES,
                        stages=_RESNET50_STAGES):
    """Bottleneck ResNet-50 parameters: stem 7x7/2 + maxpool, then stages
    of (mid_ch, n_blocks, first_stride) bottlenecks (1x1 -> 3x3 -> 1x1 with
    a 4x expansion), ending in a 1000-way linear head."""
    ones = lambda c: torch.ones((c, 1, 1), dtype=torch.bfloat16)  # noqa: E731
    params = {"stem": _he(gen, (64, in_ch, 7, 7), in_ch * 49),
              "stem_scale": ones(64), "stages": []}
    prev = 64
    for mid, n_blocks, first_stride in stages:
        out = mid * 4
        blocks = []
        for b in range(n_blocks):
            stride = first_stride if b == 0 else 1
            block = {
                "w1": _he(gen, (mid, prev, 1, 1), prev), "s1": ones(mid),
                "w2": _he(gen, (mid, mid, 3, 3), mid * 9), "s2": ones(mid),
                "w3": _he(gen, (out, mid, 1, 1), mid), "s3": ones(out),
            }
            if prev != out or stride != 1:
                block["proj"] = _he(gen, (out, prev, 1, 1), prev)
            blocks.append(block)
            prev = out
        params["stages"].append(blocks)
    params["head_w"] = _he(gen, (prev, num_classes), prev)
    params["head_b"] = torch.zeros((num_classes,), dtype=torch.bfloat16)
    return params


def _bottleneck(block, x, stride):
    h = F.relu(_conv(x, block["w1"]) * block["s1"])
    h = F.relu(_conv(h, block["w2"], stride=stride) * block["s2"])
    h = _conv(h, block["w3"]) * block["s3"]
    skip = x if "proj" not in block else _conv(x, block["proj"], stride=stride)
    return F.relu(h + skip)


@torch.no_grad()
def _resnet_features(params, x, stage_strides=None):
    """Backbone half: image -> pooled feature vector [N, C] bf16 (the head
    applies in _resnet_head).  Split out so the vision pipeline serves the
    backbone and the head as separate composing models, the feature tensor
    staying on the device between them.  Custom-``stages`` parameters need
    a matching ``stage_strides``; the default follows _RESNET50_STAGES."""
    strides = stage_strides or tuple(s for _, _, s in _RESNET50_STAGES)
    h = _compute_input(x)
    # ResNet rescales before the ReLU (the CNN after it)
    h = F.relu(_conv(h, params["stem"], stride=2) * params["stem_scale"])
    h = _max_pool(h)
    for si, blocks in enumerate(params["stages"]):
        for bi, block in enumerate(blocks):
            h = _bottleneck(block, h, strides[si] if bi == 0 else 1)
    return _mean_hw(h)


@torch.no_grad()
def _resnet_head(params, h):
    """Classification head over pooled features -> float32 scores.  The
    product rounds to bf16 and the bias is added after it, as in JAX (one
    ``F.linear`` with a bias would round once)."""
    return (_matmul(h.to(torch.bfloat16), params["head_w"])
            + params["head_b"]).float()


def _resnet_forward(params, x, stage_strides=None):
    # x: [N, 3, H, W] float32 -> scores [N, num_classes] float32
    return _resnet_head(
        params, _resnet_features(params, x, stage_strides=stage_strides))


def resnet50_flops_per_image(image_size=224, in_ch=3,
                             num_classes=_NUM_CLASSES,
                             stages=_RESNET50_STAGES):
    """Analytic forward FLOPs for one image, 2*MAC convention (convs +
    head): ~8.18e9 for 224px, i.e. 4.09 GMACs, matching torchvision's
    resnet50 profile.  MFU divides this by a peak quoted in FLOP/s, so the
    2*MAC convention is the consistent numerator."""
    def conv_out(hw, stride):
        return (hw + stride - 1) // stride

    flops = 0
    hw = conv_out(image_size, 2)  # stem 7x7/2
    flops += _conv_flops(64, in_ch, 7, 7, hw, hw)
    hw = conv_out(hw, 2)  # maxpool/2
    prev = 64
    for mid, n_blocks, first_stride in stages:
        out = mid * 4
        for b in range(n_blocks):
            stride = first_stride if b == 0 else 1
            # 1x1 reduce runs at the INPUT resolution, the 3x3 at the output
            flops += _conv_flops(mid, prev, 1, 1, hw, hw)
            hw_out = conv_out(hw, stride)
            flops += _conv_flops(mid, mid, 3, 3, hw_out, hw_out)
            flops += _conv_flops(out, mid, 1, 1, hw_out, hw_out)
            if prev != out or stride != 1:
                flops += _conv_flops(out, prev, 1, 1, hw_out, hw_out)
            prev = out
            hw = hw_out
    return flops + 2 * prev * num_classes


class ResNet50Classifier:
    """Bottleneck ResNet-50 servable (~8.2 GFLOP / 224px image) on
    *device* (``cuda`` unless the caller says otherwise)."""

    def __init__(self, seed=0, device=None):
        self.device = resolve_device(device)
        self.params = _place(
            _init_resnet_params(torch.Generator().manual_seed(seed)),
            self.device)

    def __call__(self, inputs, params, ctx):
        x = _as_device_tensor(inputs["INPUT0"], self.device)
        return {"OUTPUT0": _resnet_forward(self.params, x)}


# ---------------------------------------------------------------------------
# Vision pipeline (the ensemble workload, serve/pipeline.py): preprocess ->
# resnet backbone -> classification postprocess, all torch-backed, so every
# intermediate tensor stays on the device between steps: the DAG scheduler
# hands the tensor straight to the next composing model with no host round
# trip (ctpu_ensemble_host_hops_total stays 0).
# ---------------------------------------------------------------------------

# Tiny stage geometry for the hermetic variant: ~0.4M params.  Full-size
# callers pass stages=_RESNET50_STAGES.
_TINY_STAGES = ((16, 1, 1), (32, 1, 2))

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _pixel_stats(device):
    """ImageNet's per-channel mean and std, [1, 3, 1, 1] float32."""
    return [torch.tensor(v, dtype=torch.float32, device=device)
            .reshape(1, 3, 1, 1) for v in (_IMAGENET_MEAN, _IMAGENET_STD)]


def _normalize(x, mean, std):
    x = x.to(torch.float32) / 255.0
    x = x.permute(0, 3, 1, 2)
    return ((x - mean) / std).contiguous()


@torch.no_grad()
def _preprocess_forward(x):
    """uint8 NHWC image batch -> normalized float32 NCHW pixels."""
    return _normalize(x, *_pixel_stats(x.device))


class _StepPrograms:
    """One pipeline step's programs, keyed by its inputs' shapes and
    dtypes as ``jax.jit`` keys its executables: a ``_BucketProgram`` each
    (static inputs; on CUDA the step's forward as a graph, captured
    through ``ops.capture_graph`` at the shape's first sight; static
    outputs).

    A call copies its inputs (host arrays or tensors on the device) into
    the program's static inputs, runs it on the device's default stream
    (as every ensemble hop) and returns copies of its outputs, since the
    next call at that shape overwrites them while an ensemble hands the
    result on to another thread.  A step's graphs share one memory pool,
    so they share one lock, held from the copies in until the copies out
    are issued (``_BucketProgram``).  On the CPU the forward runs eagerly
    on the same static buffers.  No fallback: a failed capture or replay
    raises from the call."""

    def __init__(self, fn, device):
        self.fn = fn  # (inputs, params, ctx) -> outputs, as a model's
        self.device = device
        self._programs = {}  # input signature -> _BucketProgram
        # the programs, the pool, the stats, and every run and capture
        self._lock = threading.Lock()
        self._pool = self._stream = None
        self._captures = {"graphs": 0, "capture_s": 0.0}

    def shapes(self):
        """The input signatures of the programs made so far: ((name,
        shape, dtype), ...) each."""
        with self._lock:
            return list(self._programs)

    def stats(self):
        """Graphs captured, capture seconds, replays and eager runs; on
        CUDA ``memory_reserved`` before the first capture and after the
        last."""
        with self._lock:
            progs = list(self._programs.values())
            return {**self._captures,
                    "replays": sum(p.replays for p in progs),
                    "eager_runs": sum(p.eager_runs for p in progs)}

    def __call__(self, inputs):
        tensors = {}
        for name, x in inputs.items():
            if isinstance(x, torch.Tensor):
                tensors[name] = _as_device_tensor(x, self.device)
            else:
                # a wire tensor is a read-only view of the request body
                tensors[name] = torch.from_numpy(
                    np.require(x, requirements=["C", "W"]))
        key = tuple((name, tuple(t.shape), t.dtype)
                    for name, t in sorted(tensors.items()))
        with self._lock, device_stream(self.device):
            prog = self._programs.get(key) or self._build(key)
            for name, t in tensors.items():
                prog.inputs[name].copy_(t)
            prog.run()
            return {name: out.clone() for name, out in prog.outputs.items()}

    def _build(self, key):
        """The program of input signature *key*, captured on CUDA (the
        caller holds ``_lock``)."""
        shapes = {name: (shape[1:], dtype) for name, shape, dtype in key}
        prog = _BucketProgram(self.fn, shapes, key[0][1][0], self.device,
                              self._lock)
        if self.device.type == "cuda":
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
                self._stream = torch.cuda.Stream(self.device)
            before = torch.cuda.memory_reserved(self.device)
            seconds = prog.capture(self._pool, self._stream)
            stats = self._captures
            stats["graphs"] += 1
            stats["capture_s"] += seconds
            stats.setdefault("memory_reserved_before", before)
            stats["memory_reserved_after"] = torch.cuda.memory_reserved(
                self.device)
        self._programs[key] = prog
        return prog


class _VisionPipelineRunners:
    """Shared state behind the pipeline's composing models: one resnet
    parameter tree (backbone stages + classification head) on *device*,
    and each step's programs (the JAX runners' ``_pre``, ``_features``
    and ``_head`` jits; the softmax is folded into the head's)."""

    def __init__(self, stages, num_classes, seed=0, device=None):
        self.device = resolve_device(device)
        self.feature_dim = stages[-1][0] * 4
        self.strides = tuple(s for _, _, s in stages)
        self.params = _place(
            _init_resnet_params(torch.Generator().manual_seed(seed),
                                num_classes=num_classes, stages=stages),
            self.device)
        mean, std = _pixel_stats(self.device)
        self._pre = _StepPrograms(lambda inputs, params, ctx: {
            "PIXELS": _normalize(inputs["IMAGE"], mean, std)}, self.device)
        self._features = _StepPrograms(self._features_fn, self.device)
        self._head = _StepPrograms(self._head_fn, self.device)

    def _features_fn(self, inputs, params, ctx):
        # the float32 cast honors the FEATURES spec
        return {"FEATURES": _resnet_features(
            self.params, inputs["PIXELS"], stage_strides=self.strides
        ).float()}

    def _head_fn(self, inputs, params, ctx):
        return {"SCORES": torch.softmax(
            _resnet_head(self.params, inputs["FEATURES"]), dim=-1)}

    def programs(self):
        """{step: its _StepPrograms}."""
        return {"preprocess": self._pre, "backbone": self._features,
                "postprocess": self._head}

    def graph_stats(self):
        """{step: graphs captured, capture seconds, replays, eager runs
        (on CUDA only a program not captured would make one), and on CUDA
        ``memory_reserved`` before the step's first capture and after its
        last}."""
        return {step: progs.stats() for step, progs in self.programs().items()}

    def preprocess(self, inputs, params, ctx):
        return self._pre({"IMAGE": inputs["IMAGE"]})

    def backbone(self, inputs, params, ctx):
        # the PIXELS handoff arrives on the device and FEATURES stays there
        return self._features({"PIXELS": inputs["PIXELS"]})

    def postprocess(self, inputs, params, ctx):
        return self._head({"FEATURES": inputs["FEATURES"]})


def vision_pipeline_models(image_size=32, stages=_TINY_STAGES,
                           num_classes=16, max_batch_size=32, warmup=False,
                           prefix="vision", device=None):
    """The vision-pipeline model family: three torch-backed composing
    models plus the ensemble wiring them into a DAG, on *device* (``cuda``
    unless the caller says otherwise).

    - ``{prefix}_preprocess``: UINT8 NHWC image -> normalized FP32 NCHW
      (direct dispatch; its output is a device tensor, which puts the
      backbone step on the batcher's device path).
    - ``{prefix}_backbone``: resnet features, dynamic batching of device
      groups: concurrent pipeline requests fuse into real batches mid-DAG.
    - ``{prefix}_postprocess``: classification head + softmax, labels
      attached for the classification extension.
    - ``{prefix}_pipeline``: the ensemble (IMAGE -> SCORES).

    Defaults are the hermetic tiny variant; ``image_size=224,
    stages=_RESNET50_STAGES, num_classes=1000`` is the full resnet50-backed
    pipeline."""
    runners = _VisionPipelineRunners(stages, num_classes, device=device)
    labels = [f"class_{i}" for i in range(num_classes)]
    feat = runners.feature_dim
    common = dict(platform="torch", backend="torch", device=runners.device,
                  max_batch_size=max_batch_size)
    preprocess = Model(
        f"{prefix}_preprocess",
        inputs=[TensorSpec("IMAGE", "UINT8", [-1, image_size, image_size, 3])],
        outputs=[TensorSpec("PIXELS", "FP32", [-1, 3, image_size, image_size])],
        fn=runners.preprocess,
        **common,
    )
    backbone = Model(
        f"{prefix}_backbone",
        inputs=[TensorSpec("PIXELS", "FP32", [-1, 3, image_size, image_size])],
        outputs=[TensorSpec("FEATURES", "FP32", [-1, feat])],
        fn=runners.backbone,
        dynamic_batching=True,
        batch_device_inputs=True,
        warmup=warmup,
        **common,
    )
    postprocess = Model(
        f"{prefix}_postprocess",
        inputs=[TensorSpec("FEATURES", "FP32", [-1, feat])],
        outputs=[TensorSpec("SCORES", "FP32", [-1, num_classes],
                            labels=labels)],
        fn=runners.postprocess,
        **common,
    )
    pipeline = Model(
        f"{prefix}_pipeline",
        inputs=[TensorSpec("IMAGE", "UINT8", [-1, image_size, image_size, 3])],
        outputs=[TensorSpec("SCORES", "FP32", [-1, num_classes],
                            labels=labels)],
        fn=None,
        platform="ensemble",
        ensemble_steps=[
            {"model_name": f"{prefix}_preprocess",
             "input_map": {"IMAGE": "IMAGE"},
             "output_map": {"PIXELS": "pixels"}},
            {"model_name": f"{prefix}_backbone",
             "input_map": {"PIXELS": "pixels"},
             "output_map": {"FEATURES": "features"}},
            {"model_name": f"{prefix}_postprocess",
             "input_map": {"FEATURES": "features"},
             "output_map": {"SCORES": "SCORES"}},
        ],
    )
    return [preprocess, backbone, postprocess, pipeline]


def resnet50_model(name="resnet50", image_size=224, max_batch_size=64,
                   warmup=False, device=None):
    """Servable ResNet-50 (BASELINE.md config 3's model), on *device*
    (``cuda`` unless the caller says otherwise).  Reference analog: the
    resnet50 concurrency sweep perf_analyzer's README documents."""
    runner = ResNet50Classifier(device=device)
    labels = [f"class_{i}" for i in range(_NUM_CLASSES)]
    return Model(
        name,
        inputs=[TensorSpec("INPUT0", "FP32", [-1, 3, image_size, image_size])],
        outputs=[TensorSpec("OUTPUT0", "FP32", [-1, _NUM_CLASSES],
                            labels=labels)],
        fn=runner,
        platform="torch",
        backend="torch",
        device=runner.device,
        max_batch_size=max_batch_size,
        dynamic_batching=True,
        warmup=warmup,
        batch_device_inputs=True,
        fused_batching=True,
        max_fused_arity=16,
        flops_per_item=resnet50_flops_per_image(image_size),
    )
