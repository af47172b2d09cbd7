"""The port's shared-memory transports (client_tpu_torch.utils.shared_memory,
client_tpu_torch.utils.cuda_shared_memory and the server's registry) held
against tests/test_shared_memory.py and the JAX server, on the CPU.

Regions made with ``device="cpu"`` are CPU uint8 tensors that the
process-local broker resolves, so the whole server path (register over
HTTP, typed views for inputs, output copies, status, unregister) runs
here; the IPC open of another process's handle runs on the card
(tests/test_torch_cuda.py).  The JAX package's own HTTP client
(``client_tpu.http``) drives the port's server unchanged.

A port region is one flat buffer: the JAX region's device slots, dirty
ranges and lazy host-window sync (``TestTpuRegionByteSemantics``'
dirty-slot cases) have no counterpart here.  Its byte semantics do, and
are checked as there: reads at any offset, overlapping writes that keep
the other bytes, a bytearray write.

Stated tolerances: a served CNN answer through CPU regions equals the
wire path's answer for the same image bit for bit (the same bucket
program on the same values); against the JAX server's CNN over TPU
shared memory, from the same weights carried across with
``convert.params_from_numpy``, within ``FORWARD_BF16_TOL`` (1e-2) of the
largest score, as tests/test_torch_vision.py holds the two forwards.
"""

import os

import jax
import numpy as np
import pytest
import torch

import client_tpu.http as jhttp
from client_tpu.serve import Server as JaxServer
from client_tpu.serve.models import vision as jvision
from client_tpu.utils import InferenceServerException as JaxServerException
from client_tpu.utils import tpu_shared_memory as tpushm
from client_tpu_torch import convert
from client_tpu_torch.serve import Server
from client_tpu_torch.serve.model_runtime import (
    SERVER_EXTENSIONS,
    InferenceEngine,
    Model,
    TensorSpec,
)
from client_tpu_torch.serve.models import vision
from client_tpu_torch.utils import InferenceServerException, to_wire_bytes
from client_tpu_torch.utils import cuda_shared_memory as cudashm
from client_tpu_torch.utils import shared_memory as sysshm

FORWARD_BF16_TOL = 1e-2  # of the largest score (tests/test_torch_vision.py)
IMAGE = 32
IMAGE_BYTES = 3 * IMAGE * IMAGE * 4
SCORE_BYTES = 1000 * 4


def _key(tag):
    return f"/ctpu_torch_test_{tag}_{os.getpid()}"


def _images(n, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, 1, 3, IMAGE, IMAGE)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_cnn():
    """The JAX CNN at image 32; its parameters also feed the port's."""
    return jvision.cnn_classifier_model(image_size=IMAGE, max_batch_size=8)


@pytest.fixture(scope="module")
def server(jax_cnn):
    """The port's server with the CNN on the CPU, carrying the JAX CNN's
    bfloat16 parameters."""
    model = vision.cnn_classifier_model(image_size=IMAGE, max_batch_size=8,
                                        device="cpu")
    model.fn.params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jax_cnn.fn.params), "cpu")
    with Server(models=[model], http_port=0,
                with_default_models=False) as s:
        yield s


@pytest.fixture()
def client(server):
    c = jhttp.InferenceServerClient(server.http_address)
    yield c
    c.unregister_system_shared_memory()
    c.unregister_cuda_shared_memory()
    c.close()


def _shm_infer(client, in_region, out_region, offset=0, out_offset=0):
    inp = jhttp.InferInput("INPUT0", [1, 3, IMAGE, IMAGE], "FP32")
    inp.set_shared_memory(in_region, IMAGE_BYTES, offset=offset)
    out = jhttp.InferRequestedOutput("OUTPUT0")
    out.set_shared_memory(out_region, SCORE_BYTES, offset=out_offset)
    return client.infer("cnn_classifier", [inp], outputs=[out])


def _wire_infer(client, x):
    inp = jhttp.InferInput("INPUT0", [1, 3, IMAGE, IMAGE], "FP32")
    inp.set_data_from_numpy(x, binary_data=True)
    out = jhttp.InferRequestedOutput("OUTPUT0", binary_data=True)
    return client.infer("cnn_classifier", [inp],
                        outputs=[out]).as_numpy("OUTPUT0")


def test_server_names_both_extensions(client):
    meta = client.get_server_metadata()
    assert {"system_shared_memory", "cuda_shared_memory"} <= set(
        meta["extensions"])
    assert "tpu_shared_memory" not in SERVER_EXTENSIONS


# -- system shared memory -------------------------------------------------


@pytest.mark.parametrize("dtype", [np.int32, np.float32, np.uint8])
def test_system_shm_round_trip(dtype):
    """create / set / get / mapped / destroy (the JAX
    ``test_round_trip_local``), two tensors back to back."""
    key = _key("rt")
    h = sysshm.create_shared_memory_region("reg0", key, 256)
    try:
        a = np.arange(16).astype(dtype)
        b = np.full((2, 4), 3).astype(dtype)
        sysshm.set_shared_memory_region(h, [a, b])
        np.testing.assert_array_equal(
            sysshm.get_contents_as_numpy(h, dtype, [16]), a)
        np.testing.assert_array_equal(
            sysshm.get_contents_as_numpy(h, dtype, [2, 4], offset=a.nbytes),
            b)
        assert "reg0" in sysshm.mapped_shared_memory_regions()
        assert os.path.exists(sysshm.shm_path(key))
    finally:
        sysshm.destroy_shared_memory_region(h)
    assert "reg0" not in sysshm.mapped_shared_memory_regions()
    assert not os.path.exists(sysshm.shm_path(key))


def test_system_shm_bytes_and_attach():
    """A BYTES tensor read back through a second mapping of the same key
    (``create=False``), stopping at its element count."""
    key = _key("bytes")
    h = sysshm.create_shared_memory_region("owner", key, 128)
    try:
        words = np.array([b"kserve", b"", b"shm"], dtype=np.object_)
        sysshm.set_shared_memory_region(h, [words])
        other = sysshm.create_shared_memory_region("peer", key, 128,
                                                   create=False)
        got = sysshm.get_contents_as_numpy(other, "BYTES", [3])
        assert got.tolist() == [b"kserve", b"", b"shm"]
        sysshm.destroy_shared_memory_region(other, unlink=False)
        with pytest.raises(InferenceServerException, match="destroyed"):
            other.read(0, 4)
    finally:
        sysshm.destroy_shared_memory_region(h)


def test_system_shm_infer_over_http(server, client):
    """The JAX client registers two system regions on the port's server
    (which attaches them by key), reads their status, infers with input
    and output in them, and unregisters: the answer equals the wire
    path's bit for bit."""
    x = _images(1, seed=1)[0]
    h_in = sysshm.create_shared_memory_region("in_sys", _key("in"),
                                              IMAGE_BYTES)
    h_out = sysshm.create_shared_memory_region("out_sys", _key("out"),
                                               2 * SCORE_BYTES)
    try:
        sysshm.set_shared_memory_region(h_in, [x])
        client.register_system_shared_memory("in_sys", _key("in"),
                                             IMAGE_BYTES)
        client.register_system_shared_memory("out_sys", _key("out"),
                                             2 * SCORE_BYTES)
        status = client.get_system_shared_memory_status()
        assert {r["name"]: r["byte_size"] for r in status} == {
            "in_sys": IMAGE_BYTES, "out_sys": 2 * SCORE_BYTES}
        assert client.get_system_shared_memory_status("in_sys") == [{
            "name": "in_sys", "key": _key("in"), "offset": 0,
            "byte_size": IMAGE_BYTES}]
        result = _shm_infer(client, "in_sys", "out_sys",
                            out_offset=SCORE_BYTES)
        assert result.get_output("OUTPUT0")["parameters"] == {
            "shared_memory_region": "out_sys",
            "shared_memory_byte_size": SCORE_BYTES}
        got = sysshm.get_contents_as_numpy(h_out, np.float32, [1, 1000],
                                           offset=SCORE_BYTES)
        np.testing.assert_array_equal(got, _wire_infer(client, x))
        client.unregister_system_shared_memory("in_sys")
        assert [r["name"] for r in
                client.get_system_shared_memory_status()] == ["out_sys"]
        with pytest.raises(JaxServerException, match="not registered"):
            _shm_infer(client, "in_sys", "out_sys")
    finally:
        client.unregister_system_shared_memory()
        sysshm.destroy_shared_memory_region(h_in)
        sysshm.destroy_shared_memory_region(h_out)
    assert client.get_system_shared_memory_status() == []


def test_system_shm_unknown_key_answers_400(client):
    with pytest.raises(JaxServerException) as info:
        client.register_system_shared_memory("bad", "/does_not_exist_key",
                                             64)
    assert info.value.status() == "400"


def test_system_shm_reregister_with_other_attributes_answers_400(server):
    key = _key("rereg")
    h = sysshm.create_shared_memory_region("r", key, 128)
    shm = server.engine.shm
    try:
        shm.register_system("r", key, 0, 64)
        shm.register_system("r", key, 0, 64)  # the same: accepted
        with pytest.raises(InferenceServerException) as info:
            shm.register_system("r", key, 0, 128)
        assert info.value.status() == "400"
        with pytest.raises(InferenceServerException, match="overruns"):
            shm.read("r", 32, 64)
    finally:
        shm.unregister_system()
        sysshm.destroy_shared_memory_region(h)


# -- CUDA shared memory, CPU regions: the region's byte semantics ---------


@pytest.fixture()
def region():
    h = cudashm.create_shared_memory_region("cpu_region", 256, device="cpu")
    yield h
    cudashm.destroy_shared_memory_region(h)


def test_cuda_shm_local_round_trip(region):
    """The JAX ``test_local_round_trip``: numpy in, numpy out, the live
    view (``get_contents_as_torch``, the counterpart of
    ``get_contents_as_jax``) on the region's memory, the allocated list."""
    data = np.linspace(0, 1, 32, dtype=np.float32).reshape(4, 8)
    cudashm.set_shared_memory_region(region, [data])
    np.testing.assert_array_equal(
        cudashm.get_contents_as_numpy(region, "FP32", [4, 8]), data)
    live = cudashm.get_contents_as_torch(region, "FP32", [4, 8])
    assert live.data_ptr() == region.tensor.data_ptr()
    region.tensor[:4] = 0  # a write to the region shows in the view
    assert live[0, 0].item() == 0.0
    assert "cpu_region" in cudashm.allocated_shared_memory_regions()


def test_cuda_shm_destroy_forgets_the_region():
    h = cudashm.create_shared_memory_region("gone", 64, device="cpu")
    handle = cudashm.get_raw_handle(h)
    assert cudashm.resolve_inprocess(handle) is h
    view = cudashm.get_contents_as_torch(h, "INT32", [16])
    cudashm.destroy_shared_memory_region(h)
    assert "gone" not in cudashm.allocated_shared_memory_regions()
    assert cudashm.resolve_inprocess(handle) is None
    with pytest.raises(InferenceServerException, match="closed"):
        h.read(0, 4)
    assert view.sum().item() == 0  # a view keeps its memory


def test_cuda_shm_raw_handle_is_64_bytes(region):
    """The raw handle is the 64 bytes of a cudaIpcMemHandle_t, the shape
    ``register_cuda_shared_memory`` base64-encodes; each region's own."""
    other = cudashm.create_shared_memory_region("other", 8, device="cpu")
    try:
        handle = cudashm.get_raw_handle(region)
        assert isinstance(handle, bytes) and len(handle) == 64
        assert handle != cudashm.get_raw_handle(other)
        assert cudashm.resolve_inprocess(handle) is region
    finally:
        cudashm.destroy_shared_memory_region(other)


@pytest.mark.parametrize("offset", [0, 4, 40, 124])
def test_cuda_shm_arbitrary_offset_read(region, offset):
    data = np.arange(32, dtype=np.int32)  # 128 bytes at offset 0
    cudashm.set_shared_memory_region(region, [data])
    count = (128 - offset) // 4 if offset else 8
    back = cudashm.get_contents_as_numpy(region, np.int32, [count],
                                         offset=offset)
    np.testing.assert_array_equal(back, data[offset // 4:offset // 4 + count])


def test_cuda_shm_unaligned_view_is_a_copy(region):
    """A typed view at an offset its element size does not divide is read
    by a copy: right, but not the region's memory."""
    data = np.arange(8, dtype=np.float32)
    cudashm.set_shared_memory_region(region, [data], offset=2)
    got = cudashm.get_contents_as_torch(region, "FP32", [8], offset=2)
    np.testing.assert_array_equal(got.numpy(), data)
    assert got.data_ptr() != region.tensor.data_ptr() + 2


def test_cuda_shm_overlapping_writes_keep_the_other_bytes(region):
    a = np.arange(16, dtype=np.int32)  # bytes [0, 64)
    b = np.full(4, 99, dtype=np.int32)  # bytes [32, 48)
    cudashm.set_shared_memory_region(region, [a])
    cudashm.set_shared_memory_region(region, [b], offset=32)
    expect = a.copy()
    expect[8:12] = 99
    np.testing.assert_array_equal(
        cudashm.get_contents_as_numpy(region, np.int32, [16]), expect)


@pytest.mark.parametrize("value", [
    bytearray(np.arange(8, dtype=np.int32).tobytes()),
    np.arange(8, dtype=np.int32).tobytes(),
    torch.arange(8, dtype=torch.int32),
])
def test_cuda_shm_bytes_like_and_tensor_writes(region, value):
    region.write(0, value)
    np.testing.assert_array_equal(
        cudashm.get_contents_as_numpy(region, np.int32, [8]),
        np.arange(8, dtype=np.int32))


def test_cuda_shm_bytes_and_bf16_contents(region):
    """BYTES in their wire serialization; a BF16 tensor read back as
    float32 (the dtype BF16 decodes to) and viewed as torch.bfloat16."""
    words = np.array([b"a", b"bc"], dtype=np.object_)
    cudashm.set_shared_memory_region(region, [words])
    assert cudashm.get_contents_as_numpy(region, "BYTES", [2]).tolist() == [
        b"a", b"bc"]
    bf = torch.tensor([1.5, -2.0, 3.25], dtype=torch.bfloat16)
    cudashm.set_shared_memory_region(region, [bf], offset=64)
    np.testing.assert_array_equal(
        cudashm.get_contents_as_numpy(region, "BF16", [3], offset=64),
        np.float32([1.5, -2.0, 3.25]))
    assert torch.equal(
        cudashm.get_contents_as_torch(region, "BF16", [3], offset=64), bf)


def test_cuda_shm_overrun_raises(region):
    with pytest.raises(InferenceServerException, match="overrun"):
        region.write(250, np.zeros(4, dtype=np.int32))
    with pytest.raises(InferenceServerException, match="overrun"):
        cudashm.get_contents_as_numpy(region, np.int32, [8], offset=240)


def test_cuda_shm_refuses_to_run_without_cuda(monkeypatch):
    """Without CUDA a region needs ``device="cpu"``: no quiet fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cudashm.create_shared_memory_region("no_cuda", 64)


# -- the served CNN through CUDA regions (CPU) -------------------------------


def test_cuda_shm_infer_equals_wire_and_jax_tpushm(server, client, jax_cnn):
    """The JAX client registers the port's CPU regions over HTTP (status,
    unregister); each served answer read from the output region equals
    the wire path's for the same image bit for bit, and the JAX server's
    CNN over TPU shared memory within 1e-2 of the largest score."""
    images = _images(3, seed=2)
    regions = []
    try:
        h_in = cudashm.create_shared_memory_region(
            "cuda_in", 3 * IMAGE_BYTES, device="cpu")
        h_out = cudashm.create_shared_memory_region(
            "cuda_out", 3 * SCORE_BYTES, device="cpu")
        regions += [h_in, h_out]
        cudashm.set_shared_memory_region(h_in, list(images))
        client.register_cuda_shared_memory(
            "cuda_in", cudashm.get_raw_handle(h_in), 0, 3 * IMAGE_BYTES)
        client.register_cuda_shared_memory(
            "cuda_out", cudashm.get_raw_handle(h_out), 0, 3 * SCORE_BYTES)
        assert client.get_cuda_shared_memory_status() == [
            {"name": "cuda_in", "device_id": 0,
             "byte_size": 3 * IMAGE_BYTES},
            {"name": "cuda_out", "device_id": 0,
             "byte_size": 3 * SCORE_BYTES}]
        ours = []
        for i in range(3):
            result = _shm_infer(client, "cuda_in", "cuda_out",
                                offset=i * IMAGE_BYTES,
                                out_offset=i * SCORE_BYTES)
            assert result.get_output("OUTPUT0")["shape"] == [1, 1000]
            ours.append(cudashm.get_contents_as_numpy(
                h_out, "FP32", [1, 1000], offset=i * SCORE_BYTES))
        for x, got in zip(images, ours):
            np.testing.assert_array_equal(got, _wire_infer(client, x))
        client.unregister_cuda_shared_memory("cuda_in")
        assert [r["name"] for r in client.get_cuda_shared_memory_status()
                ] == ["cuda_out"]
    finally:
        client.unregister_cuda_shared_memory()
        for h in regions:
            cudashm.destroy_shared_memory_region(h)
    assert client.get_cuda_shared_memory_status() == []

    theirs = []
    with JaxServer(models=[jax_cnn], with_default_models=False) as jserver:
        jclient = jhttp.InferenceServerClient(jserver.http_address)
        t_in = tpushm.create_shared_memory_region("tpu_in", IMAGE_BYTES)
        t_out = tpushm.create_shared_memory_region("tpu_out", SCORE_BYTES)
        try:
            jclient.register_tpu_shared_memory(
                "tpu_in", tpushm.get_raw_handle(t_in), 0, IMAGE_BYTES)
            jclient.register_tpu_shared_memory(
                "tpu_out", tpushm.get_raw_handle(t_out), 0, SCORE_BYTES)
            for x in images:
                tpushm.set_shared_memory_region(t_in, [x])
                _shm_infer(jclient, "tpu_in", "tpu_out")
                theirs.append(tpushm.get_contents_as_numpy(
                    t_out, "FP32", [1, 1000]))
        finally:
            jclient.unregister_tpu_shared_memory()
            tpushm.destroy_shared_memory_region(t_in)
            tpushm.destroy_shared_memory_region(t_out)
            jclient.close()
    for got, want in zip(ours, theirs):
        err = np.abs(got - want).max()
        assert err <= FORWARD_BF16_TOL * np.abs(want).max(), err


def test_cuda_shm_foreign_handle_on_a_cpu_server_answers_400(client):
    """A handle no region of this process made needs an IPC open, which
    needs CUDA: a 400, and nothing registered."""
    with pytest.raises(JaxServerException, match="needs CUDA") as info:
        client.register_cuda_shared_memory("foreign", bytes(range(64)), 0, 64)
    assert info.value.status() == "400"
    with pytest.raises(JaxServerException, match="64 bytes"):
        client.register_cuda_shared_memory("short", b"x" * 16, 0, 64)
    assert client.get_cuda_shared_memory_status() == []


def test_tpusharedmemory_register_answers_400(client):
    """The port serves cudasharedmemory; tpusharedmemory register answers
    400 (the JAX server refuses cudasharedmemory the same way), its
    unregister is a no-op and its status empty."""
    with pytest.raises(JaxServerException,
                       match="use cudasharedmemory") as info:
        client.register_tpu_shared_memory("t", b"{}", 0, 64)
    assert info.value.status() == "400"
    client.unregister_tpu_shared_memory()
    assert client.get_tpu_shared_memory_status() == []


def test_cuda_shm_reregister_and_overrun_answer_400(server):
    shm = server.engine.shm
    h = cudashm.create_shared_memory_region("re", 64, device="cpu")
    try:
        handle = cudashm.get_raw_handle(h)
        shm.register_cuda("re", handle, 0, 64)
        shm.register_cuda("re", handle, 0, 64)  # the same: accepted
        with pytest.raises(InferenceServerException, match="different"):
            shm.register_cuda("re", handle, 0, 32)
        with pytest.raises(InferenceServerException, match="holds 64"):
            shm.register_cuda("big", handle, 0, 128)
        with pytest.raises(InferenceServerException, match="overrun"):
            shm.read_tensor("re", 32, 64, "FP32", [16])
        with pytest.raises(InferenceServerException, match="cannot hold"):
            shm.read_tensor("re", 0, 60, "FP32", [16])
        with pytest.raises(InferenceServerException, match="needs 64"):
            shm.write_tensor("re", 0, torch.zeros(16), "FP32", 32)
    finally:
        shm.unregister_cuda()
        cudashm.destroy_shared_memory_region(h)
    assert shm.cuda_status() == {}


def test_cuda_shm_bf16_input_matches_the_wire_path():
    """A BF16 input read from a region is a torch.bfloat16 view; the
    wire path decodes BF16 to float32: the same model output from both.
    A BF16 output written to a region holds the same bf16 words the wire
    would carry."""
    def fn(inputs, params, ctx):
        x = torch.as_tensor(inputs["X"]).float()
        return {"Y": (x * 2 + 1).to(torch.bfloat16)}

    model = Model("bf16", inputs=[TensorSpec("X", "BF16", [5])],
                  outputs=[TensorSpec("Y", "BF16", [5])], fn=fn,
                  platform="torch", backend="torch", device="cpu")
    engine = InferenceEngine([model])
    x = torch.tensor([0.5, -1.25, 3.0, 1e-3, 240.0], dtype=torch.bfloat16)
    h = cudashm.create_shared_memory_region("bf", 32, device="cpu")
    try:
        cudashm.set_shared_memory_region(h, [x])
        engine.shm.register_cuda("bf", cudashm.get_raw_handle(h), 0, 32)
        seen = []
        inner = model.fn
        model.fn = lambda i, p, c: seen.append(i["X"]) or inner(i, p, c)
        engine.execute("bf16", "", {
            "inputs": [{"name": "X", "datatype": "BF16", "shape": [5],
                        "parameters": {"shared_memory_region": "bf",
                                       "shared_memory_byte_size": 10}}],
            "outputs": [{"name": "Y", "parameters": {
                "shared_memory_region": "bf", "shared_memory_offset": 16,
                "shared_memory_byte_size": 10}}]}, b"")
        raw = to_wire_bytes(x.float().numpy(), "BF16")
        _, blobs = engine.execute("bf16", "", {
            "inputs": [{"name": "X", "datatype": "BF16", "shape": [5],
                        "parameters": {"binary_data_size": len(raw)}}],
            "outputs": [{"name": "Y",
                         "parameters": {"binary_data": True}}]}, raw)
        assert seen[0].dtype == torch.bfloat16
        assert seen[1].dtype == np.float32
        assert h.read(16, 10) == blobs[0]
    finally:
        engine.close()
        cudashm.destroy_shared_memory_region(h)
