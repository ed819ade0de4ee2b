"""Port: the HTTP front end (serving/http.py) beside the JAX package's.

The same weights behind both front ends: the JAX HTTP tests' tiny GRU
(V=66, E=16, U=32, carried across with ``convert.params_from_numpy``) and
``checkpoints/mobilevit_synth.ggml`` at q8_0. Greedy f32 replies agree on
token ids and text, classify on its top-k ids (logits within 1e-4), features
on ``first5`` / ``last5`` (1e-4); the reply keys and the error codes are the
same. Two divergences from the JAX front end, on purpose: a body over
``max_body_bytes`` gets 413 (JAX reads any length), and a raw GIF body is
sniffed by its magic (JAX takes it for JSON and answers 400).
"""

import base64
import concurrent.futures
import io
import json
import os
import re
import select
import signal
import socket
import subprocess
import sys
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from ggml_experiments_tpu.models import gru_textgen as jg
from ggml_experiments_tpu.serving import DecodeEngine as JEngine
from ggml_experiments_tpu.serving.http import HttpFrontend as JFrontend
from ggml_experiments_tpu_torch.convert import params_from_numpy
from ggml_experiments_tpu_torch.models import gru_textgen as tg
from ggml_experiments_tpu_torch.serving import DecodeEngine
from ggml_experiments_tpu_torch.serving.http import HttpFrontend
from ggml_experiments_tpu_torch.utils.tokenizer import CharTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VIT_TINY = os.path.join(REPO, "checkpoints", "mobilevit_synth.ggml")
GRU_SMALL = os.path.join(REPO, "tests", "goldens", "gru_small.bin")
TOK = CharTokenizer()
ENGINE_KW = dict(n_slots=4, max_prompt=16, inner_steps=8, max_pending=64)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def served():
    """(port engine, port front end, JAX engine, JAX front end) on the same
    weights, all started."""
    jparams = jg.init_params(jg.GRUConfig(vocab_size=66, embed_dim=16, units=32),
                             jax.random.PRNGKey(7))
    arrays = {"embeddings": jparams.embeddings, "kernel": jparams.cell.kernel,
              "recurrent_kernel": jparams.cell.recurrent_kernel, "bias": jparams.cell.bias,
              "dense_kernel": jparams.dense_kernel, "dense_bias": jparams.dense_bias}
    tparams = params_from_numpy({k: np.asarray(v) for k, v in arrays.items()}, device="cpu")
    eng, jeng = DecodeEngine(tparams, **ENGINE_KW), JEngine(jparams, **ENGINE_KW)
    eng.start()
    jeng.start()
    front = HttpFrontend(eng, TOK, port=0, request_timeout_s=120.0)
    jfront = JFrontend(jeng, TOK, port=0, request_timeout_s=120.0)
    front.start()
    jfront.start()
    yield eng, front, jeng, jfront
    for f in (front, jfront):
        f.stop()
    eng.stop()
    jeng.stop()


def url(front, path):
    return f"http://127.0.0.1:{front.port}{path}"


def post(front, payload, path="/v1/generate", timeout=120, raw=None, headers=None):
    data = raw if raw is not None else json.dumps(payload).encode()
    req = urllib.request.Request(url(front, path), data=data,
                                 headers=headers or {"Content-Type": "application/json"})
    return urllib.request.urlopen(req, timeout=timeout)


def code_of(fn):
    """The HTTP status ``fn()`` gets: 200, or the error's code."""
    try:
        fn().read()
        return 200
    except urllib.error.HTTPError as ex:
        return ex.code


def test_generate_matches_engine_and_jax(served):
    eng, front, _, jfront = served
    body = json.loads(post(front, {"prompt": "the ", "max_new_tokens": 15}).read())
    jbody = json.loads(post(jfront, {"prompt": "the ", "max_new_tokens": 15}).read())
    assert body.keys() == jbody.keys() and body["canceled"] is False
    assert body["tokens"] == jbody["tokens"] and body["text"] == jbody["text"]
    direct = eng.submit(TOK.encode("the "), 15).result(timeout=60)
    np.testing.assert_array_equal(np.asarray(body["tokens"]), direct)
    assert body["text"] == TOK.decode(int(t) for t in direct)


def test_streaming_chunks_arrive_per_token(served):
    _, front, _, jfront = served
    streams = []
    for f in (front, jfront):
        resp = post(f, {"prompt": "ab", "max_new_tokens": 10, "stream": True})
        assert resp.headers["Content-Type"] == "application/x-ndjson"
        streams.append([json.loads(line) for line in resp.read().splitlines() if line.strip()])
    lines, jlines = streams
    assert "id" in lines[0] and [set(x) for x in lines[1:]] == [set(x) for x in jlines[1:]]
    toks = [x["token"] for x in lines[1:-1]]
    assert toks == [x["token"] for x in jlines[1:-1]]
    final = lines[-1]
    assert final["done"] is True and final["generated"] == len(toks)
    body = json.loads(post(front, {"prompt": "ab", "max_new_tokens": 10}).read())
    assert toks == body["tokens"][-len(toks):]


def test_health_and_stats(served):
    _, front, _, jfront = served
    got = {}
    for name, f in (("port", front), ("jax", jfront)):
        health = json.loads(urllib.request.urlopen(url(f, "/v1/health"), timeout=30).read())
        stats = json.loads(urllib.request.urlopen(url(f, "/v1/stats"), timeout=30).read())
        got[name] = (health, stats)
        assert health["status"] == "ok" and health["slots"] == 4
        assert stats["tokens_generated"] > 0 and stats["requests_completed"] >= 1
    assert got["port"][0].keys() == got["jax"][0].keys()
    assert got["port"][1].keys() == got["jax"][1].keys()


def test_cancel_via_delete(served):
    _, front, _, jfront = served
    for f in (front, jfront):
        rid = json.loads(post(f, {"prompt": "zz", "max_new_tokens": 5}).read())["id"]
        out = json.loads(urllib.request.urlopen(urllib.request.Request(
            url(f, f"/v1/requests/{rid}"), method="DELETE"), timeout=30).read())
        assert out == {"id": rid, "canceled": True}


def test_bad_requests_map_to_http_errors(served):
    _, front, _, jfront = served
    for f in (front, jfront):
        assert code_of(lambda: post(f, {"prompt": ""})) == 400
        assert code_of(lambda: post(f, {"max_new_tokens": 3})) == 400
        # longer-than-max_prompt prompts are clipped, not rejected
        assert json.loads(post(f, {"prompt": "x" * 500, "max_new_tokens": 3}).read())["tokens"]
        # a sampling request on a greedy engine is a 400
        assert code_of(lambda: post(f, {"prompt": "ok", "temperature": 0.8})) == 400
        assert code_of(lambda: urllib.request.urlopen(url(f, "/v1/nope"), timeout=30)) == 404
        assert code_of(lambda: urllib.request.urlopen(urllib.request.Request(
            url(f, "/v1/requests/99999"), method="DELETE"), timeout=30)) == 404
        assert code_of(lambda: urllib.request.urlopen(urllib.request.Request(
            url(f, "/v1/requests/abc"), method="DELETE"), timeout=30)) == 400


def test_timeout_is_504_and_backpressure_is_429(served):
    """Engines that never run: the first request times out (504, and is
    canceled), the second finds the queue full (429), on both front ends."""
    eng = served[0]
    jeng = served[2]
    stalled = [(DecodeEngine(eng.params, **{**ENGINE_KW, "max_pending": 1}), HttpFrontend),
               (JEngine(jeng.params, **{**ENGINE_KW, "max_pending": 1}), JFrontend)]
    for e, cls in stalled:
        f = cls(e, TOK, port=0, request_timeout_s=1.0)
        f.start()
        try:
            assert code_of(lambda: post(f, {"prompt": "a", "max_new_tokens": 4})) == 504
            assert e._queue.queue[0].canceled
            assert code_of(lambda: post(f, {"prompt": "b", "max_new_tokens": 4})) == 429
        finally:
            f.stop()


def test_body_over_the_cap_is_413(served):
    """The port caps the body before reading it; the JAX front end reads any
    length (its http.py:191), so the same body is a 200 there."""
    eng, _, _, jfront = served
    front = HttpFrontend(eng, TOK, port=0, max_body_bytes=1024)
    front.start()
    try:
        payload = {"prompt": "y" * 2000, "max_new_tokens": 2}
        assert code_of(lambda: post(front, payload)) == 413
        assert code_of(lambda: post(jfront, payload)) == 200
        # the connection after a 413 is closed, the server keeps serving
        assert code_of(lambda: post(front, {"prompt": "ok", "max_new_tokens": 2})) == 200
    finally:
        front.stop()


def test_client_disconnect_cancels_its_request(served):
    eng, front, _, _ = served
    with socket.create_connection(("127.0.0.1", front.port), timeout=30) as s:
        body = json.dumps({"prompt": "q", "max_new_tokens": 100000, "stream": True}).encode()
        s.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
                  b"Content-Length: " + str(len(body)).encode() + b"\r\n\r\n" + body)
        head = b""
        while b'"id"' not in head:
            head += s.recv(4096)
        rid = int(re.search(rb'"id": (\d+)', head).group(1))
    req = front.find(rid)
    assert req._done.wait(30) and req.canceled


def _spawn(argv, pattern):
    """Start ``python -m ggml_experiments_tpu_torch ARGV``; (process, port)
    once its stderr names the port."""
    proc = subprocess.Popen([sys.executable, "-m", "ggml_experiments_tpu_torch", *argv],
                            stderr=subprocess.PIPE, cwd=REPO)
    buf = b""
    for _ in range(1200):   # up to 120 s to boot
        ready, _, _ = select.select([proc.stderr], [], [], 0.1)
        if ready:
            buf += os.read(proc.stderr.fileno(), 4096)
            m = re.search(pattern, buf)
            if m:
                return proc, int(m.group(1))
        if proc.poll() is not None:
            break
    proc.kill()
    raise AssertionError(f"{argv[0]} gave no port: {buf!r}")


@pytest.mark.parametrize("command", ["serve", "serve-vision"])
def test_serve_http_cli_subprocess(command):
    """``serve --http 0`` / ``serve-vision --http 0`` with ``--device cpu``:
    boots, prints its port, answers as the offline path does, and stops on
    SIGINT with rc 0."""
    if command == "serve":
        proc, port = _spawn(["serve", "--weights", GRU_SMALL, "--http", "0", "--device", "cpu",
                             "--slots", "2", "--inner-steps", "4"],
                            rb"serving HTTP on 127\.0\.0\.1:(\d+)")
    else:
        proc, port = _spawn(["serve-vision", "--weights", VIT_TINY, "--http", "0", "--device",
                             "cpu", "--image-size", "64", "--batch-sizes", "2"],
                            rb"vision service on 127\.0\.0\.1:(\d+)")
    try:
        base = f"http://127.0.0.1:{port}"
        if command == "serve":
            from ggml_experiments_tpu_torch.formats.gru_bin import load_gru_any

            body = json.loads(urllib.request.urlopen(urllib.request.Request(
                base + "/v1/generate",
                data=json.dumps({"prompt": "hi ", "max_new_tokens": 8}).encode(),
                headers={"Content-Type": "application/json"}), timeout=120).read())
            params = load_gru_any(GRU_SMALL, device="cpu")
            want = tg.generate(params, np.asarray([TOK.encode("hi ")]), np.array([3]), 11)[0]
            assert body["tokens"] == want.tolist()
        else:
            from ggml_experiments_tpu_torch.models.mobilevit import classify, load_mobilevit
            from ggml_experiments_tpu_torch.utils.image import preprocess_canvas_u8

            img = (np.arange(40 * 56 * 3) % 251).astype(np.uint8).reshape(40, 56, 3)
            body = json.loads(urllib.request.urlopen(urllib.request.Request(
                base + "/v1/classify", data=_png_bytes(img),
                headers={"Content-Type": "image/png"}), timeout=120).read())
            x = torch.from_numpy(preprocess_canvas_u8(img, 64))[None].float() / 255.0
            want = classify(load_mobilevit(VIT_TINY, device="cpu"), x)[0]
            assert body["top"][0][0] == int(want.argmax())
            assert body["top"][0][1] == pytest.approx(float(want.max()), abs=1e-4)
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_concurrent_clients(served):
    """8 concurrent clients through 4 slots, each equal to the JAX engine's
    result for its prompt."""
    _, front, jeng, _ = served
    prompts = ["a", "bb", "ccc", "dd d", "ee", "f", "gg", "hhh"]

    def one(p):
        return p, json.loads(post(front, {"prompt": p, "max_new_tokens": 12}).read())["tokens"]

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        results = dict(pool.map(one, prompts))
    for p in prompts:
        want = jeng.submit(TOK.encode(p), 12).result(timeout=60)
        np.testing.assert_array_equal(np.asarray(results[p]), want)


# -- the image endpoints ----------------------------------------------------


def _png_bytes(img_u8: np.ndarray) -> bytes:
    import struct
    import zlib

    h, w, _ = img_u8.shape
    raw = b"".join(b"\x00" + img_u8[r].tobytes() for r in range(h))

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b""))


@pytest.fixture(scope="module")
def vision_served():
    from ggml_experiments_tpu.models.mobilevit import load_mobilevit as jload
    from ggml_experiments_tpu.serving.vision import VisionEngine as JVision
    from ggml_experiments_tpu.training.image_task import TINY_CLS_CONFIG as JCFG
    from ggml_experiments_tpu.training.image_task import make_dataset
    from ggml_experiments_tpu_torch.models.mobilevit import load_mobilevit
    from ggml_experiments_tpu_torch.serving import VisionEngine
    from ggml_experiments_tpu_torch.training.image_task import TINY_CLS_CONFIG

    jparams = jload(VIT_TINY, config=JCFG, qtype="q8_0", flash_attn=False, fused_layer=False)
    tparams = load_mobilevit(VIT_TINY, config=TINY_CLS_CONFIG, qtype="q8_0", device="cpu")
    eng = VisionEngine(tparams, image_size=64, batch_sizes=(4,), compute_dtype=torch.float32,
                       transport="f32")
    jeng = JVision(jparams, image_size=64, batch_sizes=(4,), compute_dtype=np.float32,
                   transport="f32")
    eng.start()
    jeng.start()
    front, jfront = HttpFrontend(None, vision=eng, port=0), JFrontend(None, vision=jeng, port=0)
    front.start()
    jfront.start()
    x, _ = make_dataset(4, seed=5, image_size=64)
    u8 = np.clip(np.asarray(x[0]) * 255.0, 0, 255).astype(np.uint8)
    yield front, jfront, u8
    for f in (front, jfront):
        f.stop()
    eng.stop()
    jeng.stop()


def test_http_vision_endpoints(vision_served):
    front, jfront, u8 = vision_served
    png = _png_bytes(u8)
    body = json.dumps({"image_b64": base64.b64encode(png).decode(), "top_k": 3}).encode()
    raw_png = dict(raw=png, headers={"Content-Type": "image/png"})
    got = {}
    for name, f in (("port", front), ("jax", jfront)):
        cls = json.loads(post(f, {}, path="/v1/classify", raw=body).read())
        feat = json.loads(post(f, {}, path="/v1/features", **raw_png).read())
        stats = json.loads(urllib.request.urlopen(url(f, "/v1/vision/stats")).read())
        health = json.loads(urllib.request.urlopen(url(f, "/v1/health")).read())
        assert len(cls["top"]) == 3 and all(len(t) == 2 for t in cls["top"])
        assert len(feat["first5"]) == 5 and len(feat["shape"]) == 3
        assert stats["images_done"] >= 2 and health["status"] == "ok"
        assert "vision_pending" in health
        assert code_of(lambda: post(f, {"nope": 1}, path="/v1/classify")) == 400
        got[name] = cls, feat, stats, health
    (cls, feat, stats, health), (jcls, jfeat, jstats, jhealth) = got["port"], got["jax"]
    assert [t[0] for t in cls["top"]] == [t[0] for t in jcls["top"]]
    np.testing.assert_allclose([t[1] for t in cls["top"]], [t[1] for t in jcls["top"]],
                               rtol=0, atol=1e-4)
    assert feat["shape"] == jfeat["shape"]
    for k in ("first5", "last5"):
        np.testing.assert_allclose(feat[k], jfeat[k], rtol=0, atol=1e-4)
    for a, b in ((cls, jcls), (feat, jfeat), (stats, jstats), (health, jhealth)):
        assert a.keys() == b.keys()
    capped = HttpFrontend(None, vision=front.vision, port=0, max_body_bytes=len(png) - 1)
    capped.start()
    try:
        assert code_of(lambda: post(capped, {}, path="/v1/features", **raw_png)) == 413
    finally:
        capped.stop()


def test_gif_body_sent_raw(vision_served):
    """A raw GIF body with no image Content-Type: the port sniffs GIF's magic
    and classifies it as it classifies the same pixels as PNG; the JAX front
    end has no GIF magic and answers 400."""
    from PIL import Image

    front, jfront, u8 = vision_served
    q = np.asarray(Image.fromarray(u8).convert("P", palette=Image.ADAPTIVE).convert("RGB"))
    buf = io.BytesIO()
    Image.fromarray(q).convert("P", palette=Image.ADAPTIVE).save(buf, format="GIF")
    gif = buf.getvalue()
    assert gif[:6] in (b"GIF87a", b"GIF89a")
    plain = {"Content-Type": "application/octet-stream"}
    by_gif = json.loads(post(front, {}, path="/v1/classify", raw=gif, headers=plain).read())
    by_png = json.loads(post(front, {}, path="/v1/classify", raw=_png_bytes(q),
                             headers=plain).read())
    assert [t[0] for t in by_gif["top"]] == [t[0] for t in by_png["top"]]
    assert code_of(lambda: post(jfront, {}, path="/v1/classify", raw=gif, headers=plain)) == 400
