"""The port's HTTP server over the port's session against the JAX package's
server over the JAX session, on the same weights.

Real sockets and threads on ephemeral ports, urllib clients. Tiny models of
``test_torch_trainer.py`` (CNN) and ``test_torch_vit_trainer.py`` (ViT),
synthetic DAQUAR images, fixed batch 4:

* ``/healthz``: the same fields and values;
* ``/v1/ask`` by ``image_path`` and by ``image_b64``, ``/v1/ask_batch``
  (6 requests: two chunks) and ``/v1/generate`` (ViT; greedy and 3 beams):
  the same answers and tokens, probabilities within 1e-4 (fp32);
* the error taxonomy: every bad request gets the same status and the same
  body from both servers (bad JSON, a body over ``MAX_BODY_BYTES``,
  missing and mistyped fields, bad base64, unknown routes, generate on the
  CNN family), and an image that does not decode is a 500 in both;
* the ``image_root`` allowlist, and ``image_path`` refused on a
  non-loopback bind without one;
* 8 concurrent clients get the answers a lone client gets;
* ``python -m t5_resnet_vqa_torch.serve`` serves a checkpoint on the CPU
  and refuses a mesh.
"""

import base64
import concurrent.futures
import http.client
import json
import os
import tempfile
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from t5_resnet_vqa_tpu.data import make_synthetic_daquar
from t5_resnet_vqa_tpu.eval import VQAInferenceSession as JaxSession
from t5_resnet_vqa_tpu.eval.http_server import VQAHTTPServer as JaxServer
from t5_resnet_vqa_torch.data import load_answer_spaces
from t5_resnet_vqa_torch.eval import VQAInferenceSession
from t5_resnet_vqa_torch.eval.http_server import (
    MAX_BODY_BYTES,
    VQAHTTPServer,
    _BadRequest,
)
from t5_resnet_vqa_torch.serve import build_server
from t5_resnet_vqa_torch.train import factory

import test_torch_trainer as cnn_case
import test_torch_vit_trainer as vit_case
from test_torch_resume import _jax_model_and_params

torch.set_num_threads(4)

PROB_TOL = 1e-4
CASES = {"cnn": cnn_case, "vit": vit_case}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("http")
    root, kw = make_synthetic_daquar(str(tmp / "daquar"), num_train=4,
                                     num_test=4, image_size=64,
                                     source_hw=(48, 80))
    answers = load_answer_spaces(os.path.join(root, kw["answer_spaces_file"]))
    images_dir = os.path.join(root, kw["images_dir"])
    images = [os.path.join(images_dir, f) for f in sorted(os.listdir(
        images_dir))]
    return dict(tmp=tmp, root=root, kw=kw, answers=answers,
                images_dir=images_dir, images=images)


@pytest.fixture(scope="module", params=["cnn", "vit"])
def served(request, data):
    family = request.param
    answers = data["answers"]
    jmodel, params = _jax_model_and_params(family, len(answers))
    jax_session = JaxSession(jmodel, params, answers, family, batch_size=4,
                             image_size=64)
    session = VQAInferenceSession(
        CASES[family]._port_model(len(answers), params), None, answers,
        family, batch_size=4, image_size=64, device="cpu")
    servers = {"port": VQAHTTPServer(session, port=0).start(),
               "jax": JaxServer(jax_session, port=0).start()}
    yield dict(family=family, servers=servers, **data)
    for server in servers.values():
        server.close()


def _call(server, method, path, body=None, raw=None):
    url = f"http://{server.host}:{server.port}{path}"
    data = raw if raw is not None else (
        json.dumps(body).encode() if body is not None else None)
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _both(served, method, path, body=None, raw=None):
    return {name: _call(server, method, path, body, raw)
            for name, server in served["servers"].items()}


def _request_files():
    tmp = tempfile.gettempdir()
    return {f for f in os.listdir(tmp) if f.startswith("vqa_req_")}


def _assert_answers_equal(got, want):
    assert got["answer"] == want["answer"]
    assert got["top_answers"] == want["top_answers"]
    np.testing.assert_allclose(got["top_probs"], want["top_probs"], rtol=0,
                               atol=PROB_TOL)


def test_healthz(served):
    out = _both(served, "GET", "/healthz")
    assert out["port"][0] == out["jax"][0] == 200
    got, want = out["port"][1], out["jax"][1]
    assert set(got) == set(want) == {"status", "family", "batch_size",
                                     "answer_space_size", "requests_served"}
    assert {k: got[k] for k in ("status", "family", "batch_size",
                                "answer_space_size")} == \
        {k: want[k] for k in ("status", "family", "batch_size",
                              "answer_space_size")}
    assert got["family"] == served["family"]


def test_ask_by_path_and_by_b64(served):
    image = served["images"][0]
    with open(image, "rb") as f:
        b64 = base64.b64encode(f.read()).decode()
    before = _request_files()
    for body in ({"image_path": image, "question": "what is on the table",
                  "top_k": 3},
                 {"image_b64": b64, "question": "what is on the table",
                  "top_k": 3}):
        out = _both(served, "POST", "/v1/ask", body)
        assert out["port"][0] == out["jax"][0] == 200
        _assert_answers_equal(out["port"][1], out["jax"][1])
        assert len(out["port"][1]["top_answers"]) == 3
    assert _request_files() == before      # the b64 temp files are gone


def test_ask_batch(served):
    reqs = [{"image_path": served["images"][i % len(served["images"])],
             "question": f"what is on the table {i}"} for i in range(6)]
    out = _both(served, "POST", "/v1/ask_batch",
                {"requests": reqs, "top_k": 2})
    assert out["port"][0] == out["jax"][0] == 200
    got, want = out["port"][1]["results"], out["jax"][1]["results"]
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        _assert_answers_equal(g, w)


def test_generate(served):
    body = {"image_path": served["images"][1],
            "question": "what colour is the object"}
    if served["family"] != "vit":
        out = _both(served, "POST", "/v1/generate", body)
        assert out["port"] == out["jax"]
        assert out["port"][0] == 400
        return
    for beams in (1, 3):
        with pytest.warns(UserWarning):
            out = _both(served, "POST", "/v1/generate",
                        dict(body, num_beams=beams, max_answer_length=4))
        assert out["port"][0] == out["jax"][0] == 200
        got, want = out["port"][1], out["jax"][1]
        assert set(got) == set(want)
        assert got["token_ids"] == want["token_ids"]
        assert got["answer_text"] == want["answer_text"]
        if beams > 1:
            assert got["score"] == pytest.approx(want["score"], abs=PROB_TOL)


def test_error_taxonomy(served, tmp_path):
    image = served["images"][0]
    bad = [
        ("GET", "/nope", None, None),
        ("POST", "/v1/nope", {}, None),
        ("POST", "/v1/ask", None, b"{not json"),
        ("POST", "/v1/ask", {}, None),
        ("POST", "/v1/ask", {"image_path": 5, "question": "q"}, None),
        ("POST", "/v1/ask", {"image_path": str(tmp_path / "none.png"),
                             "question": "q"}, None),
        ("POST", "/v1/ask", {"image_b64": "!!not base64!!",
                             "question": "q"}, None),
        ("POST", "/v1/ask", {"image_path": image, "question": 3}, None),
        ("POST", "/v1/ask_batch", {"requests": []}, None),
        ("POST", "/v1/ask_batch", {"requests": [{"image_path": image}]},
         None),
    ]
    for method, path, body, raw in bad:
        out = _both(served, method, path, body, raw)
        assert out["port"] == out["jax"], (method, path, body)
        assert out["port"][0] in (400, 404)
    # a body over the bound, refused before it is read
    for name, server in served["servers"].items():
        conn = http.client.HTTPConnection(server.host, server.port,
                                          timeout=60)
        conn.putrequest("POST", "/v1/ask")
        conn.putheader("Content-Length", str(MAX_BODY_BYTES + 1))
        conn.endheaders()
        resp = conn.getresponse()
        assert resp.status == 400
        assert json.loads(resp.read()) == {
            "error": f"body over {MAX_BODY_BYTES} bytes"}
        conn.close()
    # valid base64 of bytes that are no image: a 500 with the error's type
    body = {"image_b64": base64.b64encode(b"no image").decode(),
            "question": "q"}
    out = _both(served, "POST", "/v1/ask", body)
    assert out["port"][0] == out["jax"][0] == 500
    for status, payload in out.values():
        assert payload["error"].startswith(
            "FileNotFoundError: cannot decode image")


def test_image_root_allowlist(served, tmp_path):
    session = served["servers"]["port"].session
    outside = tmp_path / "outside.png"
    outside.write_bytes(open(served["images"][0], "rb").read())
    servers = {"port": VQAHTTPServer(session, port=0,
                                     image_root=served["images_dir"]),
               "jax": JaxServer(served["servers"]["jax"].session, port=0,
                                image_root=served["images_dir"])}
    try:
        for server in servers.values():
            server.start()
        root = {"servers": servers}
        out = _both(root, "POST", "/v1/ask",
                    {"image_path": str(outside), "question": "q"})
        assert out["port"] == out["jax"] == (
            400, {"error": "image_path outside the served image root"})
        out = _both(root, "POST", "/v1/ask",
                    {"image_path": served["images"][2], "question": "q"})
        assert out["port"][0] == out["jax"][0] == 200
        _assert_answers_equal(out["port"][1], out["jax"][1])
    finally:
        for server in servers.values():
            server.close()
    # a non-loopback bind without a root refuses image_path, not image_b64
    server = VQAHTTPServer(session, port=0).start()
    try:
        server._loopback = False
        # the request handler answers this exception with a 400
        with pytest.raises(_BadRequest, match="disabled on non-loopback"):
            server.handle("POST", "/v1/ask",
                          {"image_path": served["images"][0],
                           "question": "q"})
        with open(served["images"][0], "rb") as f:
            b64 = base64.b64encode(f.read()).decode()
        status, _ = server.handle("POST", "/v1/ask",
                                  {"image_b64": b64, "question": "q"})
        assert status == 200
    finally:
        server.close()


def test_concurrent_clients(served):
    server = served["servers"]["port"]
    bodies = [{"image_path": served["images"][i % len(served["images"])],
               "question": f"what is on the table {i}", "top_k": 2}
              for i in range(8)]
    alone = [_call(server, "POST", "/v1/ask", b) for b in bodies]
    before = _call(server, "GET", "/healthz")[1]["requests_served"]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        together = list(pool.map(
            lambda b: _call(server, "POST", "/v1/ask", b), bodies))
    assert together == alone
    after = _call(server, "GET", "/healthz")[1]["requests_served"]
    assert after == before + 8


def test_serve_cli(data, monkeypatch, capsys):
    for mesh in (["--data-parallel", "2"], ["--model-parallel", "2"]):
        with pytest.raises(NotImplementedError, match="item 11"):
            build_server(mesh)
    answers = data["answers"]
    out_dir = data["tmp"] / "serve_ckpt"
    ckpt = out_dir / "model_checkpoints"
    ckpt.mkdir(parents=True)
    torch.save(cnn_case._port_model(len(answers)).state_dict(),
               str(ckpt / "best-model.pt"))
    with open(ckpt / "model_ckpt_info.json", "w") as f:
        json.dump({"answer_spaces": answers}, f)
    monkeypatch.setattr(factory, "build_model",
                        lambda cfg, n, device=None, generator=None:
                        (cnn_case._port_model(n), "cnn"))
    raw = cnn_case._raw_config(data["root"], data["kw"], out_dir)
    path = cnn_case._write(out_dir, raw)
    server = build_server(["--config", path, "--port", "0",
                           "--batch-size", "2"])
    server.start()
    try:
        assert f"on http://127.0.0.1:{server.port}" in capsys.readouterr().out
        status, health = _call(server, "GET", "/healthz")
        assert status == 200
        assert (health["family"], health["batch_size"],
                health["answer_space_size"]) == ("cnn", 2, len(answers))
        status, res = _call(server, "POST", "/v1/ask",
                            {"image_path": data["images"][0],
                             "question": "what is here"})
        assert status == 200 and res["answer"] in answers
    finally:
        server.close()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw["trainer_kwargs"]["device"] = "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_server(["--config", cnn_case._write(out_dir, raw)])
