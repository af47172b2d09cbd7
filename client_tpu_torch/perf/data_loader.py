"""Input-data provisioning for the perf harness.

Covers the reference DataLoader's three sources (reference
src/c++/perf_analyzer/data_loader.h:38-146): generated (random/zeros),
a directory of raw tensor files, and the multi-stream multi-step JSON format
(``{"data": [...]}`` with typed or b64 content), plus expected-output
validation data.

The port's copy of client_tpu/perf/data_loader.py: it seeds
``np.random.default_rng(rng_seed)`` as the reference does, so the same
flags give the same arrays in both packages.
"""

import base64
import json
import os

import numpy as np

from client_tpu_torch.utils import (
    InferenceServerException,
    deserialize_bytes_tensor,
    serialize_byte_tensor,
    triton_to_np_dtype,
)


def _resolve_shape(dims, batch_size, shape_overrides, name):
    shape = list(shape_overrides.get(name, dims))
    out = []
    for i, d in enumerate(shape):
        if d in (-1, "-1"):
            if i == 0 and batch_size:
                out.append(int(batch_size))  # dynamic batch dim
                continue
            raise InferenceServerException(
                f"input '{name}' has dynamic shape {shape}; provide --shape "
                f"{name}:d1,d2,..."
            )
        out.append(int(d))
    return out


class TensorData:
    """One concrete tensor payload for a (stream, step)."""

    def __init__(self, array, is_shape_tensor=False):
        self.array = array
        self.is_shape_tensor = is_shape_tensor


class DataLoader:
    """Produces per-(stream, step) input tensors and expected outputs.

    ``streams`` is a list of steps; each step maps input name -> TensorData.
    Sequence workloads walk the steps of one stream in order; stateless
    workloads round-robin over (stream, step).
    """

    def __init__(self, inputs_metadata, batch_size=1, shape_overrides=None,
                 rng_seed=0):
        self._inputs = inputs_metadata  # list of {name, datatype, shape}
        self._batch = batch_size
        self._shapes = shape_overrides or {}
        self._rng = np.random.default_rng(rng_seed)
        self.streams = []
        self.expected_outputs = []  # parallel to streams: step -> {name: array}

    # -- generation ----------------------------------------------------------

    def generate_data(self, zero_data=False, string_length=16, num_steps=1):
        """Random (or zero) data, one stream (data_loader.h GenerateData)."""
        steps = []
        for _ in range(num_steps):
            step = {}
            for meta in self._inputs:
                name = meta["name"]
                shape = _resolve_shape(
                    meta["shape"], self._batch, self._shapes, name
                )
                step[name] = TensorData(
                    self._gen_tensor(meta["datatype"], shape, zero_data,
                                     string_length)
                )
            steps.append(step)
        self.streams = [steps]
        self.expected_outputs = [[{} for _ in steps]]

    def _gen_tensor(self, datatype, shape, zero, string_length):
        if datatype == "BYTES":
            if zero:
                flat = [b"" for _ in range(int(np.prod(shape)))]
            else:
                alphabet = np.frombuffer(
                    b"abcdefghijklmnopqrstuvwxyz0123456789", np.uint8
                )
                flat = [
                    bytes(self._rng.choice(alphabet, string_length))
                    for _ in range(int(np.prod(shape)))
                ]
            return np.array(flat, dtype=np.object_).reshape(shape)
        np_dtype = triton_to_np_dtype(datatype)
        if np_dtype is None:
            raise InferenceServerException(f"unsupported datatype {datatype}")
        if zero:
            return np.zeros(shape, np_dtype)
        if np.issubdtype(np_dtype, np.floating):
            return self._rng.random(shape).astype(np_dtype)
        if np_dtype == np.bool_:
            return self._rng.integers(0, 2, shape).astype(np.bool_)
        info = np.iinfo(np_dtype)
        lo, hi = max(info.min, -1024), min(info.max, 1024)
        return self._rng.integers(lo, hi + 1, shape).astype(np_dtype)

    def generate_prefix_share(self, share, num_prompts=16, shared_pool=4,
                              scalar_int_value=16, vocab=256):
        """LM workload with a controlled prompt-prefix share (the
        ``--prefix-share`` knob): ``num_prompts`` streams whose token
        input starts with one of ``shared_pool`` shared prefixes covering
        ``share`` of the prompt, the tail unique per stream — so a
        KV prefix cache's prefill savings are measurable from the CLI
        (share 0.8 ≈ 80% of prefill compute adoptable once warm).

        The prompt rides the first multi-element INT tensor (``TOKENS``
        by name when present); values stay in ``[1, vocab)`` so byte-
        vocab LMs accept them.  Single-element INT inputs (``MAX_TOKENS``
        and friends) get ``scalar_int_value`` — a random budget could be
        negative, which would make every stream empty.  Other inputs
        generate as usual.
        """
        share = float(share)
        if not 0.0 <= share <= 1.0:
            raise InferenceServerException(
                f"--prefix-share must be in [0, 1], got {share}"
            )
        token_meta = None
        for meta in self._inputs:
            shape = _resolve_shape(
                meta["shape"], self._batch, self._shapes, meta["name"]
            )
            if not meta["datatype"].startswith(("INT", "UINT")):
                continue
            if meta["name"] == "TOKENS":
                token_meta = meta
                break
            if token_meta is None and int(np.prod(shape)) > 1:
                token_meta = meta
        if token_meta is None:
            raise InferenceServerException(
                "--prefix-share needs an integer token input (e.g. the "
                "LM models' TOKENS); this model has none"
            )
        token_shape = _resolve_shape(
            token_meta["shape"], self._batch, self._shapes,
            token_meta["name"],
        )
        prompt_len = int(np.prod(token_shape))
        prefix_len = int(round(share * prompt_len))
        prefixes = [
            self._rng.integers(1, vocab, prefix_len).astype(np.int32)
            for _ in range(max(int(shared_pool), 1))
        ]
        self.streams = []
        for i in range(int(num_prompts)):
            step = {}
            for meta in self._inputs:
                name = meta["name"]
                shape = _resolve_shape(
                    meta["shape"], self._batch, self._shapes, name
                )
                if meta is token_meta:
                    row = self._rng.integers(
                        1, vocab, prompt_len
                    ).astype(np.int32)
                    row[:prefix_len] = prefixes[i % len(prefixes)]
                    arr = row.reshape(token_shape)
                elif (meta["datatype"].startswith(("INT", "UINT"))
                        and int(np.prod(shape)) == 1):
                    arr = np.full(shape, int(scalar_int_value),
                                  triton_to_np_dtype(meta["datatype"]))
                else:
                    arr = self._gen_tensor(meta["datatype"], shape, False, 16)
                step[name] = TensorData(arr)
            self.streams.append([step])
        self.expected_outputs = [[{}] for _ in self.streams]

    # -- directory of raw files ----------------------------------------------

    def read_data_from_dir(self, data_dir):
        """One file per input, raw little-endian bytes (ReadDataFromDir)."""
        step = {}
        for meta in self._inputs:
            name = meta["name"]
            path = os.path.join(data_dir, name)
            if not os.path.exists(path):
                raise InferenceServerException(
                    f"missing input data file {path}"
                )
            shape = _resolve_shape(meta["shape"], self._batch, self._shapes, name)
            with open(path, "rb") as f:
                raw = f.read()
            if meta["datatype"] == "BYTES":
                arr = deserialize_bytes_tensor(
                    np.frombuffer(raw, np.uint8)
                ).reshape(shape)
            else:
                np_dtype = triton_to_np_dtype(meta["datatype"])
                arr = np.frombuffer(raw, np_dtype).reshape(shape)
            step[name] = TensorData(arr)
        self.streams = [[step]]
        self.expected_outputs = [[{}]]

    # -- JSON ----------------------------------------------------------------

    def read_data_from_json(self, path_or_obj):
        """The reference's JSON format (ReadDataFromJSON): ``data`` is a list
        of streams; each stream is a list of steps (or a single step dict);
        values may be flat typed lists, ``{"content": [...], "shape": [...]}``
        dicts, or ``{"b64": "..."}``; ``validation_data`` mirrors it for
        expected outputs."""
        if isinstance(path_or_obj, (str, os.PathLike)):
            with open(path_or_obj) as f:
                doc = json.load(f)
        else:
            doc = path_or_obj
        if "data" not in doc:
            raise InferenceServerException('JSON input data needs a "data" key')
        self.streams = [
            self._parse_stream(stream) for stream in doc["data"]
        ]
        val = doc.get("validation_data")
        if val:
            self.expected_outputs = [
                self._parse_stream(stream, outputs=True) for stream in val
            ]
        else:
            self.expected_outputs = [
                [{} for _ in steps] for steps in self.streams
            ]

    def _parse_stream(self, stream, outputs=False):
        if isinstance(stream, dict):
            stream = [stream]
        steps = []
        for step_doc in stream:
            step = {}
            metas = (
                {m["name"]: m for m in self._inputs} if not outputs else None
            )
            for name, value in step_doc.items():
                meta = metas.get(name) if metas else None
                step[name] = self._parse_tensor(name, value, meta)
            steps.append(step)
        return steps

    def _parse_tensor(self, name, value, meta):
        datatype = meta["datatype"] if meta else None
        shape = None
        content = value
        if isinstance(value, dict):
            if "b64" in value:
                raw = base64.b64decode(value["b64"])
                if meta is None:
                    raise InferenceServerException(
                        f"b64 content for unknown tensor '{name}'"
                    )
                rshape = _resolve_shape(
                    value.get("shape", meta["shape"]), self._batch,
                    self._shapes, name,
                )
                if datatype == "BYTES":
                    flat = deserialize_bytes_tensor(
                        np.frombuffer(raw, np.uint8)
                    )
                    return TensorData(flat.reshape(rshape))
                np_dtype = triton_to_np_dtype(datatype)
                return TensorData(np.frombuffer(raw, np_dtype).reshape(rshape))
            shape = value.get("shape")
            content = value.get("content")
            if content is None:
                raise InferenceServerException(
                    f"tensor '{name}' dict needs 'content' or 'b64'"
                )
        flat = np.asarray(content).reshape(-1)
        if datatype == "BYTES" or (datatype is None and flat.dtype.kind in "US"):
            arr = np.array(
                [s.encode() if isinstance(s, str) else s for s in flat],
                dtype=np.object_,
            )
        elif datatype is not None:
            arr = flat.astype(triton_to_np_dtype(datatype))
        else:
            arr = flat
        if shape is None and meta is not None:
            shape = _resolve_shape(meta["shape"], self._batch, self._shapes, name)
        if shape is not None:
            arr = arr.reshape(shape)
        return TensorData(arr)

    # -- access --------------------------------------------------------------

    @property
    def num_streams(self):
        return len(self.streams)

    def num_steps(self, stream_id):
        return len(self.streams[stream_id])

    def get_input_data(self, stream_id, step_id):
        return self.streams[stream_id][step_id]

    def get_expected_outputs(self, stream_id, step_id):
        if stream_id < len(self.expected_outputs):
            steps = self.expected_outputs[stream_id]
            if step_id < len(steps):
                return steps[step_id]
        return {}
