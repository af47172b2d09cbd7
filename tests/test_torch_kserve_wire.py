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
- The management and shared-memory requests of the C++ examples
  (ModelReady/-Metadata/-Config/-Statistics, the region name requests,
  repository load and unload, the system and CUDA region registrations)
  encode byte-equal to protobuf's serialization of the same fields; the
  responses they read (live/ready, server and model metadata, model
  config, repository index, statistics, region status) read, through
  kserve_messages.h's accessors, what protobuf reads from the same
  bytes: one or two messages concatenated (protobuf merges them), each
  with known fields the classes do not keep and unknown fields of every
  wire type, at the top and nested.  Tolerance: exact.
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
from client_tpu_torch._proto import model_config_pb2 as mc
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


# -- the management and shared-memory messages -------------------------------

_uint64 = st.integers(0, 2 ** 64 - 1)


@settings(max_examples=100, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(name=_text, version=_text, config=_text, key=_text,
       handle=st.binary(min_size=64, max_size=64), device=_int64,
       offset=_uint64, size=_uint64)
def test_management_requests_encode_as_protobuf_does(
        tool, name, version, config, key, handle, device, offset, size):
    def want(message):
        return "ok " + hx(message.SerializeToString())

    got = tool(f"model_request {hx(name)} {hx(version)}")
    for cls in (pb.ModelReadyRequest, pb.ModelMetadataRequest,
                pb.ModelConfigRequest, pb.ModelStatisticsRequest):
        assert got == want(cls(name=name, version=version))
    got = tool(f"name_request {hx(name)}")
    for cls in (pb.SystemSharedMemoryStatusRequest,
                pb.SystemSharedMemoryUnregisterRequest,
                pb.CudaSharedMemoryStatusRequest,
                pb.CudaSharedMemoryUnregisterRequest):
        assert got == want(cls(name=name))
    load = pb.RepositoryModelLoadRequest(model_name=name)
    if config:
        load.parameters["config"].string_param = config
    assert tool(f"repository_request {hx(name)} {hx(config)}") == want(load)
    assert tool(f"repository_request {hx(name)} x") == want(
        pb.RepositoryModelUnloadRequest(model_name=name))
    assert tool(f"system_register {hx(name)} {hx(key)} {offset} {size}") == (
        want(pb.SystemSharedMemoryRegisterRequest(
            name=name, key=key, offset=offset, byte_size=size)))
    assert tool(f"cuda_register {hx(name)} {hx(handle)} {device} {size}") == (
        want(pb.CudaSharedMemoryRegisterRequest(
            name=name, raw_handle=handle, device_id=device, byte_size=size)))


def with_unknown(message, unknown):
    """*message* with the *unknown* fields' bytes after its own: protobuf
    keeps them and writes them again where the message is nested."""
    out = type(message)()
    out.MergeFromString(message.SerializeToString() + b"".join(unknown))
    return out


_unknown = st.lists(st.sampled_from(UNKNOWN), max_size=2)
_shape = st.lists(_int64, max_size=4)
_tensor = st.builds(
    lambda n, d, s, u: with_unknown(
        pb.ModelMetadataResponse.TensorMetadata(name=n, datatype=d, shape=s),
        u), _text, st.sampled_from(DTYPES), _shape, _unknown)
_duration = st.builds(
    lambda c, ns, u: with_unknown(pb.StatisticDuration(count=c, ns=ns), u),
    _uint64, _uint64, _unknown)
_model_stats = st.builds(
    lambda n, v, c, ok, bad, u: with_unknown(pb.ModelStatistics(
        name=n, version=v, inference_count=c,
        inference_stats=with_unknown(
            pb.InferStatistics(success=ok, fail=bad), u)), u),
    _text, _text, _uint64, _duration, _duration, _unknown)

# command -> (protobuf class, a strategy of one message, its description)
RESPONSES = {
    "flag": (pb.ServerLiveResponse, st.builds(
        lambda v: pb.ServerLiveResponse(live=v), st.booleans()),
        lambda m: f" ready {int(m.live)}"),
    "empty": (pb.CudaSharedMemoryRegisterResponse, st.builds(
        pb.CudaSharedMemoryRegisterResponse), lambda m: ""),
    "server_metadata": (pb.ServerMetadataResponse, st.builds(
        lambda n, v, e: pb.ServerMetadataResponse(
            name=n, version=v, extensions=e),
        _text, _text, st.lists(_text, max_size=3)),
        lambda m: f" name {hx(m.name)} version {hx(m.version)}"),
    "model_metadata": (pb.ModelMetadataResponse, st.builds(
        lambda n, vs, p, i, o: pb.ModelMetadataResponse(
            name=n, versions=vs, platform=p, inputs=i, outputs=o),
        _text, st.lists(_text, max_size=2), _text,
        st.lists(_tensor, max_size=3), st.lists(_tensor, max_size=3)),
        lambda m: f" name {hx(m.name)}" + "".join(
            f" {word} {hx(t.name)} {hx(t.datatype)} {len(t.shape)}"
            + "".join(f" {d}" for d in t.shape)
            for word, tensors in (("input", m.inputs), ("output", m.outputs))
            for t in tensors)),
    "model_config": (pb.ModelConfigResponse, st.builds(
        lambda n, b, u: pb.ModelConfigResponse(config=with_unknown(
            mc.ModelConfig(name=n, max_batch_size=b), u)),
        _text, st.integers(-2 ** 31, 2 ** 31 - 1), _unknown),
        lambda m: f" max_batch_size {m.config.max_batch_size}"),
    "repository_index": (pb.RepositoryIndexResponse, st.builds(
        lambda ms: pb.RepositoryIndexResponse(models=[
            pb.RepositoryIndexResponse.ModelIndex(
                name=n, version=v, state="READY", reason=r)
            for n, v, r in ms]),
        st.lists(st.tuples(_text, _text, _text), max_size=4)),
        lambda m: f" models {len(m.models)}"),
    "model_statistics": (pb.ModelStatisticsResponse, st.builds(
        lambda ms: pb.ModelStatisticsResponse(model_stats=ms),
        st.lists(_model_stats, max_size=3)),
        lambda m: "".join(
            f" stat {hx(s.name)} success {s.inference_stats.success.count}"
            for s in m.model_stats)),
    "system_status": (pb.SystemSharedMemoryStatusResponse, st.builds(
        lambda rs: pb.SystemSharedMemoryStatusResponse(regions={
            k: pb.SystemSharedMemoryStatusResponse.RegionStatus(
                name=n, key=key, offset=o, byte_size=b)
            for k, (n, key, o, b) in rs.items()}),
        st.dictionaries(_text, st.tuples(_text, _text, _uint64, _uint64),
                        max_size=3)),
        lambda m: "".join(
            f" region {hx(k)} {hx(r.name)} {hx(r.key)} {r.offset} "
            f"{r.byte_size}"
            for k, r in sorted(m.regions.items(),
                               key=lambda kv: kv[0].encode()))),
    "cuda_status": (pb.CudaSharedMemoryStatusResponse, st.builds(
        lambda rs: pb.CudaSharedMemoryStatusResponse(regions={
            k: pb.CudaSharedMemoryStatusResponse.RegionStatus(
                name=n, device_id=d, byte_size=b)
            for k, (n, d, b) in rs.items()}),
        st.dictionaries(_text, st.tuples(_text, _uint64, _uint64),
                        max_size=3)),
        lambda m: "".join(
            f" region {hx(k)} {hx(r.name)} {r.device_id} {r.byte_size}"
            for k, r in sorted(m.regions.items(),
                               key=lambda kv: kv[0].encode()))),
}


@pytest.mark.parametrize("command", sorted(RESPONSES))
@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.function_scoped_fixture])
@given(data=st.data())
def test_management_response_reads_what_protobuf_reads(tool, command, data):
    cls, message, describe = RESPONSES[command]
    parts = data.draw(st.lists(st.tuples(message, _unknown), min_size=1,
                               max_size=2))
    wire = b"".join(m.SerializeToString() + b"".join(u) for m, u in parts)
    want = cls.FromString(wire)  # two messages merge
    assert tool(f"{command} {hx(wire)}") == "ok" + describe(want)


@pytest.mark.parametrize("command", sorted(RESPONSES))
def test_a_management_response_cut_short_is_refused(tool, command):
    cls = RESPONSES[command][0]
    message = {
        "flag": pb.ServerLiveResponse(live=True),
        "empty": pb.ServerLiveResponse(live=True),  # one field, any field
        "server_metadata": pb.ServerMetadataResponse(name="s", version="1"),
        "model_metadata": pb.ModelMetadataResponse(
            name="m", inputs=[pb.ModelMetadataResponse.TensorMetadata(
                name="IN", datatype="FP32", shape=[1, 300])]),
        "model_config": pb.ModelConfigResponse(
            config=mc.ModelConfig(name="m", max_batch_size=300)),
        "repository_index": pb.RepositoryIndexResponse(models=[
            pb.RepositoryIndexResponse.ModelIndex(name="m", state="READY")]),
        "model_statistics": pb.ModelStatisticsResponse(model_stats=[
            pb.ModelStatistics(name="m", inference_stats=pb.InferStatistics(
                success=pb.StatisticDuration(count=300)))]),
        "system_status": pb.SystemSharedMemoryStatusResponse(regions={
            "r": pb.SystemSharedMemoryStatusResponse.RegionStatus(
                name="r", key="/k", byte_size=300)}),
        "cuda_status": pb.CudaSharedMemoryStatusResponse(regions={
            "r": pb.CudaSharedMemoryStatusResponse.RegionStatus(
                name="r", byte_size=300)}),
    }[command]
    data = message.SerializeToString()
    for cut in (1, len(data) - 1):
        with pytest.raises(DecodeError):
            cls.FromString(data[:-cut])
        assert tool(f"{command} {hx(data[:-cut])}") == "malformed"
