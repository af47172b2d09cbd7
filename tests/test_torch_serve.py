"""The port's serving stack (client_tpu_torch.serve) held against
client_tpu's.

The served lm_streaming_int8 runs the port's _LmRunner on weights carried
across from the JAX package (tests/test_language.py's tiny config, float32)
and must stream the JAX _LmRunner's tokens: over HTTP with MAX_TOKENS=1
(the decoupled rule allows exactly one response there) and through
engine.execute, the decoupled generator path, with MAX_TOKENS=8.  The wire
codecs are held against client_tpu.utils / client_tpu._codec byte for
byte.
"""

import gzip
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax

from client_tpu import _codec as jcodec
from client_tpu import utils as jutils
from client_tpu._infer_types import _np_from_json_data as j_np_from_json_data
from client_tpu.serve.models import language as jlanguage
from client_tpu.serve.models import transformer as jtfm
from client_tpu_torch import _codec, convert, utils
from client_tpu_torch._infer_types import _np_from_json_data
from client_tpu_torch.serve import Server
from client_tpu_torch.serve.models import language
from client_tpu_torch.serve.models import transformer as tfm

_JTINY = jtfm.TransformerConfig(
    vocab_size=258, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq=64, dtype="float32",
)
_TINY = tfm.TransformerConfig(
    vocab_size=258, d_model=64, n_layers=2, n_heads=4, n_kv_heads=2,
    d_ff=128, max_seq=64, dtype="float32",
)
_PROMPT = jlanguage.encode_text("hello, port")


@pytest.fixture(scope="module")
def jax_params():
    return jtfm.init_params(jax.random.PRNGKey(0), _JTINY)


@pytest.fixture(scope="module")
def jax_int8_stream(jax_params):
    """The JAX package's lm_streaming_int8 runner: 8 greedy tokens."""
    runner = jlanguage._LmRunner(cfg=_JTINY, params=jax_params, quantize=True)
    return list(runner.stream(_PROMPT, 8))


@pytest.fixture(scope="module")
def server(jax_params):
    params = convert.params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jax_params), "cpu")
    runner = language._LmRunner(cfg=_TINY, params=params, device="cpu")
    int8 = language._LmRunner(cfg=_TINY, params=params, quantize=True,
                              device="cpu")
    models = [
        language.tokenizer_model(),
        language.detokenizer_model(),
        language.lm_streaming_model(runner=runner),
        language.lm_streaming_model(name="lm_streaming_int8", runner=int8),
        language.text_ensemble_model(runner=runner),
    ]
    with Server(models=models, http_port=0, with_default_models=False) as s:
        yield s


def _http(server, path, body=None, headers=None):
    req = urllib.request.Request(
        f"http://{server.http_address}{path}", data=body,
        headers=headers or {}, method="POST" if body is not None else "GET",
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, resp.read(), dict(resp.headers)


def _lm_request(tokens, max_tokens):
    return {"inputs": [
        {"name": "TOKENS", "shape": [len(tokens)], "datatype": "INT32",
         "data": [int(t) for t in tokens]},
        {"name": "MAX_TOKENS", "shape": [1], "datatype": "INT32",
         "data": [max_tokens]},
    ]}


class _Input:
    """Minimal input object for the request-body builders."""

    def __init__(self, name, arr, datatype, binary):
        self._name, self._arr, self._dt, self._binary = name, arr, datatype, binary

    def name(self):
        return self._name

    def shape(self):
        return list(self._arr.shape)

    def datatype(self):
        return self._dt

    def parameters(self):
        if self._binary:
            return {"binary_data_size": len(self.raw_data())}
        return {}

    def raw_data(self):
        if not self._binary:
            return None
        return utils.to_wire_bytes(self._arr, self._dt)

    def nonbinary_data(self):
        if self._binary:
            return None
        if self._dt == "BYTES":
            return [v.decode() for v in self._arr.flatten()]
        return self._arr.flatten().tolist()


def test_served_int8_http_first_token_equals_jax(server, jax_int8_stream):
    """lm_streaming_int8 over the port's HTTP (MAX_TOKENS=1) against the
    JAX _LmRunner(quantize=True).stream on the same weights."""
    _, body, _ = _http(
        server, "/v2/models/lm_streaming_int8/infer",
        json.dumps(_lm_request(_PROMPT, 1)).encode())
    out = {o["name"]: o for o in json.loads(body)["outputs"]}
    assert out["TOKEN"]["data"] == [jax_int8_stream[0]]


@pytest.mark.parametrize("binary,encoding", [(True, "gzip"),
                                             (False, "deflate")])
def test_served_int8_binary_and_compression(server, jax_int8_stream, binary,
                                            encoding):
    """The binary tensor extension and compressed bodies both ways give
    the same first token."""
    inputs = [
        _Input("TOKENS", _PROMPT.astype(np.int32), "INT32", binary),
        _Input("MAX_TOKENS", np.array([1], dtype=np.int32), "INT32", binary),
    ]
    body, json_size = _codec.build_infer_request_body(inputs)
    headers = {"Content-Encoding": encoding, "Accept-Encoding": encoding}
    if json_size is not None:
        headers["Inference-Header-Content-Length"] = str(json_size)
    _, raw, resp_headers = _http(
        server, "/v2/models/lm_streaming_int8/infer",
        _codec.compress(body, encoding), headers)
    assert resp_headers["Content-Encoding"] == encoding
    raw = _codec.decompress(raw, encoding)
    header, blobs = _codec.parse_infer_response_body(
        raw, resp_headers.get("Inference-Header-Content-Length"))
    token = next(o for o in header["outputs"] if o["name"] == "TOKEN")
    assert token["parameters"]["binary_data_size"] == 4
    assert utils.from_wire_bytes(blobs[:4], "INT32", [1]).tolist() == \
        [jax_int8_stream[0]]


def test_engine_execute_streams_jax_tokens(server, jax_int8_stream):
    """engine.execute on lm_streaming_int8 (MAX_TOKENS=8), the decoupled
    generator path, against the JAX runner's 8-token stream."""
    stream = server.engine.execute(
        "lm_streaming_int8", "", _lm_request(_PROMPT, 8), b"")
    assert not isinstance(stream, tuple)
    tokens = []
    for response, blobs in stream:
        assert response["parameters"]["triton_final_response"] is False
        assert blobs == []
        tokens.append(response["outputs"][0]["data"][0])
    assert tokens == jax_int8_stream


def test_decoupled_http_rule(server):
    """More than one response over HTTP is a 400 naming gRPC streaming."""
    with pytest.raises(urllib.error.HTTPError) as err:
        _http(server, "/v2/models/lm_streaming_int8/infer",
              json.dumps(_lm_request(_PROMPT, 3)).encode())
    assert err.value.code == 400
    assert "gRPC streaming" in json.loads(err.value.read())["error"]


def test_overlong_prompt_is_a_400(server):
    too_long = np.arange(_TINY.max_seq + 4) % 255
    with pytest.raises(urllib.error.HTTPError) as err:
        _http(server, "/v2/models/lm_streaming/infer",
              json.dumps(_lm_request(too_long, 1)).encode())
    assert err.value.code == 400
    assert "maximum context" in json.loads(err.value.read())["error"]


def test_tokenizer_and_detokenizer_over_http(server):
    req = {"inputs": [{"name": "TEXT", "shape": [2], "datatype": "BYTES",
                       "data": ["ab", "wxyz"]}]}
    _, body, _ = _http(server, "/v2/models/tokenizer/infer",
                       json.dumps(req).encode())
    out = {o["name"]: o for o in json.loads(body)["outputs"]}
    assert out["LENGTHS"]["data"] == [3, 5]
    assert out["TOKENS"]["shape"] == [2, 5]
    toks = language.encode_text("roundtrip")
    req = {"inputs": [{"name": "TOKENS", "shape": [1, len(toks)],
                       "datatype": "INT32", "data": toks.tolist()}]}
    _, body, _ = _http(server, "/v2/models/detokenizer/infer",
                       json.dumps(req).encode())
    assert json.loads(body)["outputs"][0]["data"] == ["roundtrip"]


@pytest.mark.parametrize("path,status", [
    ("/v2/health/live", 200),
    ("/v2/health/ready", 200),
    ("/v2/models/lm_streaming_int8/ready", 200),
    ("/v2/models/lm_streaming_int8/versions/1/ready", 200),
    ("/v2/models/nope/ready", 400),
    ("/v2/models/lm_streaming_int8/stats", 200),
    ("/v2/repository/index", 404),  # POST only, as in the JAX server
    ("/metrics", 200),
])
def test_health_and_unported_endpoints(server, path, status):
    try:
        code = _http(server, path)[0]
    except urllib.error.HTTPError as e:
        code = e.code
    assert code == status


def test_metadata_and_config(server):
    _, body, _ = _http(server, "/v2")
    assert json.loads(body)["name"] == "client_tpu_torch.serve"
    _, body, _ = _http(server, "/v2/models/lm_streaming_int8")
    meta = json.loads(body)
    assert meta["name"] == "lm_streaming_int8"
    assert [t["name"] for t in meta["inputs"]] == ["TOKENS", "MAX_TOKENS"]
    _, body, _ = _http(server, "/v2/models/lm_streaming_int8/config")
    cfg = json.loads(body)
    assert cfg["model_transaction_policy"] == {"decoupled": True}
    assert cfg["input"][0]["data_type"] == "TYPE_INT32"
    _, body, _ = _http(server, "/v2/models/text_generator/config")
    assert json.loads(body)["input"][0]["data_type"] == "TYPE_STRING"


def test_statistics_count_success_and_failure(server):
    before = server.engine.statistics("tokenizer")[0]["inference_stats"]
    server.engine.execute(
        "tokenizer", "", {"inputs": [{"name": "TEXT", "shape": [1],
                                      "datatype": "BYTES", "data": ["x"]}]},
        b"")
    with pytest.raises(utils.InferenceServerException):
        server.engine.execute("tokenizer", "", {"inputs": []}, b"")
    after = server.engine.statistics("tokenizer")[0]["inference_stats"]
    assert after["success"]["count"] == before["success"]["count"] + 1
    assert after["fail"]["count"] == before["fail"]["count"] + 1


@pytest.mark.parametrize("arr", [
    np.array([b"a", b"", "ü".encode()], dtype=np.object_),
    np.array([[b"xy"], [b"z"]], dtype=np.object_),
])
def test_bytes_codec_matches_jax(arr):
    """serialize/deserialize_byte_tensor against client_tpu.utils."""
    wire = utils.serialize_byte_tensor(arr).tobytes()
    assert wire == jutils.serialize_byte_tensor(arr).tobytes()
    back = utils.deserialize_bytes_tensor(wire)
    assert back.tolist() == jutils.deserialize_bytes_tensor(wire).tolist()


def test_bf16_codec_matches_jax():
    """BF16 wire bytes against client_tpu.utils (round to nearest even);
    the port decodes to float32, exactly the bf16 values."""
    x = np.random.default_rng(0).standard_normal(37).astype(np.float32)
    x[:3] = [1.00390625, -2.5, 0.0]  # a tie, an exact value, zero
    wire = utils.serialize_bf16_tensor(x).tobytes()
    assert wire == jutils.serialize_bf16_tensor(x).tobytes()
    back = utils.from_wire_bytes(wire, "BF16", [37])
    assert back.dtype == np.float32
    np.testing.assert_array_equal(
        back, jutils.deserialize_bf16_tensor(wire).astype(np.float32))


@pytest.mark.parametrize("datatype,data,shape", [
    ("INT32", [1, 2, 3, 4], [2, 2]),
    ("FP32", [0.5, -1.0], [2]),
    ("BOOL", [True, False], [2]),
    ("BYTES", ["ab", "c"], [2]),
])
def test_json_data_matches_jax(datatype, data, shape):
    got = _np_from_json_data(data, datatype, shape)
    want = j_np_from_json_data(data, datatype, shape)
    assert got.dtype == want.dtype and got.tolist() == want.tolist()


def test_request_and_response_bodies_match_jax():
    """build/parse of the request and response bodies, and compression,
    against client_tpu._codec."""
    inputs = [_Input("X", np.arange(4, dtype=np.int32), "INT32", True),
              _Input("S", np.array([b"q"], dtype=np.object_), "BYTES", False)]
    assert _codec.build_infer_request_body(inputs, request_id="7") == \
        jcodec.build_infer_request_body(inputs, request_id="7")
    resp = ({"model_name": "m", "outputs": []}, [b"\x01\x02"])
    body, size = _codec.build_infer_response_body(*resp)
    assert (body, size) == jcodec.build_infer_response_body(*resp)
    assert _codec.parse_infer_response_body(body, str(size)) == \
        jcodec.parse_infer_response_body(body, str(size))
    assert gzip.decompress(_codec.compress(body, "gzip")) == body
    assert _codec.decompress(jcodec.compress(body, "deflate"), "deflate") == body
    with pytest.raises(utils.InferenceServerException):
        _codec.decompress(body, "br")


def test_dtype_tables_match_jax():
    for dt in (np.bool_, np.int8, np.int32, np.uint64, np.float16, np.float32,
               np.object_):
        assert utils.np_to_triton_dtype(dt) == jutils.np_to_triton_dtype(dt)
    for name in ("INT8", "UINT16", "FP64", "BYTES"):
        assert utils.triton_to_np_dtype(name) == jutils.triton_to_np_dtype(name)
    assert utils.triton_to_np_dtype("BF16") == np.float32  # decodes widened


def test_text_generator_streams_pieces(server):
    """The ensemble chains tokenizer -> LM: same pieces as lm_streaming."""
    req = {"inputs": [
        {"name": "PROMPT", "shape": [1], "datatype": "BYTES",
         "data": ["hello, port"]},
        {"name": "MAX_TOKENS", "shape": [1], "datatype": "INT32", "data": [4]},
    ]}
    pieces = [r[0]["outputs"][0]["data"][0]
              for r in server.engine.execute("text_generator", "", req, b"")]
    toks = [r[0]["outputs"][0]["data"][0] for r in server.engine.execute(
        "lm_streaming", "", _lm_request(_PROMPT, 4), b"")]
    assert pieces == [language.decode_tokens([t]) for t in toks]


def test_empty_final_response_when_asked(server):
    """triton_enable_empty_final_response ends the decoupled stream with
    one empty response marked final (the completion protocol gRPC
    streaming clients use)."""
    req = dict(_lm_request(_PROMPT, 2), id="r1",
               parameters={"triton_enable_empty_final_response": True})
    responses = [r for r, _ in server.engine.execute(
        "lm_streaming_int8", "", req, b"")]
    assert [r["parameters"]["triton_final_response"] for r in responses] == \
        [False, False, True]
    assert responses[-1]["outputs"] == [] and responses[-1]["id"] == "r1"
    assert all(r["id"] == "r1" for r in responses)
