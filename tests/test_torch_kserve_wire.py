"""The port's protobuf-free KServe codec
(client_tpu_torch/perf/csrc/kserve_wire.{h,cc}) held against protobuf's own
encoding of proto/inference.proto, through the port's byte copy
``client_tpu_torch._proto.inference_pb2``, on the CPU.

The codec's line tool (csrc/kserve_wire_tool.cc) is built like the
native worker (``native_worker.build_native``: g++ alone) and kept running
for the module; every string and bytes field travels as hex.

- A ModelInferRequest the codec encodes from hypothesis-drawn names,
  datatypes, shapes (any int64), parameters of all four oneof members
  (and none), raw contents in pieces and shared-memory parameters parses
  with inference_pb2 into the message Python builds from the same draw.
- A ModelInferResponse and a ModelStreamInferResponse that Python
  serializes (with unknown fields of every wire type appended, or not)
  decode to the same fields, the final-response flag (the reference
  client's ``triton_final_response`` reading) and ``error_message``
  included.  Tolerance: exact.
- A message cut short is refused, as protobuf refuses it.
- The build stamp: a matching stamp does not rebuild; a changed source,
  compiler string or flag does.
"""

import os
import shutil
import struct
import subprocess

import pytest
from google.protobuf.message import DecodeError
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from client_tpu_torch._proto import inference_pb2 as pb
from client_tpu_torch.perf import native_worker as native

DTYPES = ["BOOL", "UINT8", "INT8", "INT16", "INT32", "INT64", "FP16",
          "BF16", "FP32", "FP64", "BYTES"]
KEYS = ["triton_final_response", "shared_memory_region",
        "shared_memory_byte_size", "shared_memory_offset", "sequence_id",
        "classification", ""]


@pytest.fixture(scope="module")
def tool():
    binary = native.build_native("kserve_wire_tool", native.WIRE_TOOL_SOURCES)
    proc = subprocess.Popen([binary], stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, text=True)

    def ask(line):
        proc.stdin.write(line + "\n")
        proc.stdin.flush()
        return proc.stdout.readline().strip()

    yield ask
    proc.stdin.close()
    proc.wait(timeout=30)


def hx(data):
    return "x" + (data.encode() if isinstance(data, str) else data).hex()


# -- parameters ---------------------------------------------------------------

_int64 = st.integers(-2 ** 63, 2 ** 63 - 1)
_text = st.text(max_size=10)
_param = st.one_of(
    st.tuples(st.just("b"), st.booleans()),
    st.tuples(st.just("i"), _int64),
    st.tuples(st.just("s"), _text),
    st.tuples(st.just("d"), st.floats(allow_nan=False)),
    st.just(("n", None)),
)
_params = st.dictionaries(st.one_of(st.sampled_from(KEYS), _text), _param,
                          max_size=4)


def param_token(kind, value):
    if kind == "n":
        return "n"
    if kind == "b":
        return f"b {int(value)}"
    if kind == "i":
        return f"i {value}"
    if kind == "s":
        return f"s {hx(value)}"
    return "d %016x" % struct.unpack("<Q", struct.pack("<d", value))[0]


def set_param(param_map, key, kind, value):
    p = param_map[key]  # an entry with no member set for "n"
    if kind == "b":
        p.bool_param = value
    elif kind == "i":
        p.int64_param = value
    elif kind == "s":
        p.string_param = value
    elif kind == "d":
        p.double_param = value


def params_tokens(word, params):
    """The tool's tokens of a parameter map, in its order (std::map:
    the keys' UTF-8 bytes)."""
    out = []
    for key in sorted(params, key=lambda k: k.encode()):
        out.append(f"{word} {hx(key)} {param_token(*params[key])}")
    return out


def pb_params_tokens(word, param_map):
    params = {}
    for key, p in param_map.items():
        member = p.WhichOneof("parameter_choice")
        params[key] = ({"bool_param": "b", "int64_param": "i",
                        "string_param": "s", "double_param": "d",
                        None: "n"}[member],
                       None if member is None else getattr(p, member))
    return params_tokens(word, params)


# -- requests -----------------------------------------------------------------

_shm = st.fixed_dictionaries(
    {"shared_memory_region": st.tuples(st.just("s"), _text),
     "shared_memory_byte_size": st.tuples(st.just("i"),
                                          st.integers(0, 2 ** 40))},
    optional={"shared_memory_offset": st.tuples(st.just("i"),
                                                st.integers(1, 2 ** 40))})
_input = st.fixed_dictionaries({
    "name": _text, "datatype": st.sampled_from(DTYPES),
    "shape": st.lists(_int64, max_size=5),
    # raw pieces (the buffers AppendRaw kept), or shm parameters
    "raw": st.one_of(st.lists(st.binary(max_size=24), max_size=3),
                     st.none()),
    "shm": _shm, "params": _params})
_output = st.fixed_dictionaries({
    "name": _text, "params": _params,
    "shm": st.one_of(st.none(), _shm)})
_request = st.fixed_dictionaries({
    "model": _text, "version": _text, "id": _text, "params": _params,
    "inputs": st.lists(_input, max_size=3),
    "outputs": st.lists(_output, max_size=3)})


def request_line_and_message(spec):
    """The tool's request line for *spec*, and the message the reference
    client would put on the wire for it."""
    msg = pb.ModelInferRequest(model_name=spec["model"],
                               model_version=spec["version"], id=spec["id"])
    words = ["request", "model", hx(spec["model"]), "version",
             hx(spec["version"]), "id", hx(spec["id"])]
    for key, (kind, value) in spec["params"].items():
        words.append(f"param {hx(key)} {param_token(kind, value)}")
        set_param(msg.parameters, key, kind, value)
    raws = []
    for t in spec["inputs"]:
        tensor = msg.inputs.add(name=t["name"], datatype=t["datatype"],
                                shape=t["shape"])
        words.append(f"input {hx(t['name'])} {hx(t['datatype'])} "
                     f"{len(t['shape'])} " + " ".join(map(str, t["shape"])))
        params = dict(t["params"])
        if t["raw"] is None:
            params.update(t["shm"])
        else:
            raws.append(t["raw"])
        for key, (kind, value) in params.items():
            words.append(f"iparam {hx(key)} {param_token(kind, value)}")
            set_param(tensor.parameters, key, kind, value)
    for o in spec["outputs"]:
        tensor = msg.outputs.add(name=o["name"])
        words.append(f"output {hx(o['name'])}")
        params = {**o["params"], **(o["shm"] or {})}
        for key, (kind, value) in params.items():
            words.append(f"oparam {hx(key)} {param_token(kind, value)}")
            set_param(tensor.parameters, key, kind, value)
    for pieces in raws:
        words.append(f"raw {len(pieces)} " + " ".join(map(hx, pieces)))
        msg.raw_input_contents.append(b"".join(pieces))
    return " ".join(words), msg


@settings(max_examples=300, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(spec=_request)
def test_request_encoding_parses_equal_to_protobufs(tool, spec):
    line, want = request_line_and_message(spec)
    answer = tool(line)
    assert answer.startswith("ok x"), answer
    got = pb.ModelInferRequest.FromString(bytes.fromhex(answer[4:]))
    assert got == want


def test_request_encoding_of_the_workers_shapes(tool):
    """The worker's own request kinds, field by field: a wire input of
    ResNet-50's size, an shm input and output, a decoupled request."""
    payload = bytes(range(256)) * 2352  # [1, 3, 224, 224] FP32
    spec = {"model": "resnet50", "version": "", "id": "d-1",
            "params": {"triton_enable_empty_final_response": ("b", True),
                       "sequence_id": ("i", 2 ** 40),
                       "sequence_start": ("b", False)},
            "inputs": [
                {"name": "INPUT", "datatype": "FP32",
                 "shape": [1, 3, 224, 224], "raw": [payload[:7], payload[7:]],
                 "shm": {}, "params": {}},
                {"name": "IN2", "datatype": "FP32", "shape": [1, 4],
                 "raw": None, "params": {},
                 "shm": {"shared_memory_region": ("s", "r_in"),
                         "shared_memory_byte_size": ("i", 16)}}],
            "outputs": [{"name": "OUTPUT0", "params": {},
                         "shm": {"shared_memory_region": ("s", "r_out"),
                                 "shared_memory_byte_size": ("i", 4000),
                                 "shared_memory_offset": ("i", 64)}}]}
    line, want = request_line_and_message(spec)
    got = pb.ModelInferRequest.FromString(bytes.fromhex(tool(line)[4:]))
    assert got == want
    assert got.raw_input_contents[0] == payload
    assert got.parameters["sequence_start"].WhichOneof(
        "parameter_choice") == "bool_param"


# -- responses ----------------------------------------------------------------

_out_tensor = st.fixed_dictionaries({
    "name": _text, "datatype": st.sampled_from(DTYPES),
    "shape": st.lists(_int64, max_size=5), "params": _params,
    "bytes": st.lists(st.binary(max_size=12), max_size=3)})
_response = st.fixed_dictionaries({
    "model": _text, "version": _text, "id": _text, "params": _params,
    "outputs": st.lists(_out_tensor, max_size=3),
    "raw": st.lists(st.binary(max_size=24), max_size=3)})

# one unknown field of each wire type (varint, fixed64, length-delimited,
# fixed32), numbered past every field inference.proto uses
UNKNOWN = [bytes([0xc8, 0x03]) + b"\x96\x01",   # 57, varint 150
           bytes([0xc9, 0x03]) + bytes(8),      # 57, fixed64
           bytes([0xca, 0x03, 0x03]) + b"abc",  # 57, length-delimited
           bytes([0xcd, 0x03]) + bytes(4)]      # 57, fixed32


def response_message(spec):
    msg = pb.ModelInferResponse(model_name=spec["model"],
                                model_version=spec["version"], id=spec["id"])
    for key, (kind, value) in spec["params"].items():
        set_param(msg.parameters, key, kind, value)
    for t in spec["outputs"]:
        tensor = msg.outputs.add(name=t["name"], datatype=t["datatype"],
                                 shape=t["shape"])
        for key, (kind, value) in t["params"].items():
            set_param(tensor.parameters, key, kind, value)
        if t["bytes"]:
            tensor.contents.bytes_contents.extend(t["bytes"])
    msg.raw_output_contents.extend(spec["raw"])
    return msg


def expected_description(resp, error=""):
    """The tool's description of *resp* as the reference client reads
    it (grpc_client.cc ParseGrpcInferResult: triton_final_response's
    bool_param, outputs' bytes_contents)."""
    final = ("triton_final_response" in resp.parameters
             and resp.parameters["triton_final_response"].bool_param)
    words = ["ok", "model", hx(resp.model_name), "version",
             hx(resp.model_version), "id", hx(resp.id), "final",
             str(int(final)), "error", hx(error)]
    words += pb_params_tokens("param", resp.parameters)
    for o in resp.outputs:
        words.append(f"output {hx(o.name)} {hx(o.datatype)} {len(o.shape)}"
                     + "".join(f" {d}" for d in o.shape))
        words += pb_params_tokens("oparam", o.parameters)
        words += [f"bytes {hx(b)}" for b in o.contents.bytes_contents]
    words += [f"raw {hx(r)}" for r in resp.raw_output_contents]
    return " ".join(words)


@settings(max_examples=300, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(spec=_response, unknown=st.lists(st.sampled_from(UNKNOWN),
                                        max_size=3))
def test_response_decodes_to_protobufs_fields(tool, spec, unknown):
    resp = response_message(spec)
    data = resp.SerializeToString() + b"".join(unknown)
    assert tool(f"response {hx(data)}") == expected_description(resp)


@settings(max_examples=200, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(spec=_response, error=_text, final=st.booleans(),
       unknown=st.lists(st.sampled_from(UNKNOWN), max_size=2))
def test_stream_response_decodes_to_protobufs_fields(tool, spec, error,
                                                     final, unknown):
    resp = response_message(spec)
    resp.parameters["triton_final_response"].bool_param = final
    msg = pb.ModelStreamInferResponse(error_message=error,
                                      infer_response=resp)
    data = msg.SerializeToString() + b"".join(unknown)
    answer = tool(f"stream {hx(data)}")
    assert answer == expected_description(resp, error)
    assert (" final 1 " in answer) == final


@pytest.mark.parametrize("kind", ["response", "stream"])
def test_a_message_cut_short_is_refused(tool, kind):
    resp = pb.ModelInferResponse(model_name="m", id="7",
                                 raw_output_contents=[b"\x01" * 40])
    data = (resp if kind == "response" else pb.ModelStreamInferResponse(
        infer_response=resp)).SerializeToString()
    cls = (pb.ModelInferResponse if kind == "response"
           else pb.ModelStreamInferResponse)
    for cut in (1, 5, len(data) - 2):
        with pytest.raises(DecodeError):
            cls.FromString(data[:-cut])
        assert tool(f"{kind} {hx(data[:-cut])}") == "malformed"


# -- the build stamp ----------------------------------------------------------

def test_stamp_decides_the_rebuild(tmp_path, monkeypatch):
    """build_native rebuilds when a source, the compiler's --version or
    the flags change, and not when the stamp matches."""
    src = tmp_path / "src"
    src.mkdir()
    sources = []
    for path in native.WIRE_TOOL_SOURCES:
        shutil.copy(path, src)
        sources.append(str(src / os.path.basename(path)))
    build = str(tmp_path / "build")

    def build_once():
        before = native.last_build
        binary = native.build_native("kserve_wire_tool", sources,
                                     build_dir=build)
        return binary, native.last_build is not before

    binary, built = build_once()
    assert built and os.path.exists(binary)
    with open(binary + ".stamp") as f:
        assert f.read().strip() == native.build_stamp(sources)
    assert build_once() == (binary, False)

    with open(sources[1], "a") as f:
        f.write("\n// changed\n")
    assert build_once() == (binary, True)
    assert build_once() == (binary, False)

    version = native._compiler_version()
    monkeypatch.setattr(native, "_compiler_version",
                        lambda: version + " (another build)")
    assert build_once() == (binary, True)
    assert build_once() == (binary, False)

    monkeypatch.setattr(native, "CXXFLAGS", [*native.CXXFLAGS, "-g0"])
    assert build_once() == (binary, True)
    assert build_once() == (binary, False)
