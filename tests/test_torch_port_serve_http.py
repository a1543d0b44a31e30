"""The port's HTTP front-end (``si_mamba_tpu_torch/serve_http.py``), mirroring
tests/test_serve_http.py with stub batch functions, plus one small real
``Predictor`` on the CPU held against the port's ``predict_proba`` (within
1e-6: the reply rounds to 6 places) and against the JAX package's server
over the same weights (within 1e-4, the same label). The xyz ordering
('MAMBA') keeps eigenvector signs out of the comparison."""

import io
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from si_mamba_tpu_torch import serve_http
from si_mamba_tpu_torch.serve_http import MAX_BODY, make_server, shutdown_server

OCTET = "application/octet-stream"


def _start(fn, make=make_server, **kw):
    server = make(fn, port=0, **kw)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    host, port = server.server_address
    return server, f"http://{host}:{port}"


def _post(url, data, content_type=OCTET):
    req = urllib.request.Request(f"{url}/predict", data=data,
                                 headers={"Content-Type": content_type})
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def _npy_bytes(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _checksum(batch):
    return np.tile(batch.sum(axis=(1, 2))[:, None], (1, 2))


def test_http_predict_both_formats_and_health():
    def fn(batch):  # (b, N, 3) -> (b, 4), the mass on class 2
        out = np.full((len(batch), 4), 0.1, np.float64)
        out[:, 2] = 0.7
        return out

    server, url = _start(fn, max_batch=4, max_delay_ms=2)
    try:
        cloud = np.zeros((16, 3), np.float32)
        r1 = _post(url, _npy_bytes(cloud))
        assert r1 == {"label": 2, "probs": [0.1, 0.1, 0.7, 0.1]}
        r2 = _post(url, json.dumps({"points": cloud.tolist()}).encode(), "application/json")
        assert r2 == r1
        with urllib.request.urlopen(f"{url}/healthz", timeout=60) as r:
            h = json.loads(r.read())
        assert h == {"ok": True, "n_requests": 2, "n_batches": 2, "mean_batch_size": 1.0}
    finally:
        shutdown_server(server)


def test_http_concurrent_requests_coalesce():
    """8 concurrent clients against a fn held on its first call: the requests
    queued meanwhile land in batches of two or more."""
    entered, release = threading.Event(), threading.Event()
    sizes = []

    def fn(batch):
        sizes.append(len(batch))
        entered.set()
        release.wait(timeout=30)
        return _checksum(batch)

    server, url = _start(fn, max_batch=8, max_delay_ms=50)
    try:
        rng = np.random.default_rng(0)
        clouds = [rng.standard_normal((8, 3)).astype(np.float32) for _ in range(8)]
        results = [None] * 8

        def client(i):
            results[i] = _post(url, _npy_bytes(clouds[i]))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        assert entered.wait(timeout=30)
        release.set()
        for t in threads:
            t.join(timeout=60)
        for i, r in enumerate(results):
            assert r is not None, i
            np.testing.assert_allclose(r["probs"][0], clouds[i].sum(), rtol=1e-4)
        assert sum(sizes) == 8 and max(sizes) >= 2, sizes
    finally:
        shutdown_server(server)


def test_http_error_paths():
    server, url = _start(lambda b: 1 / 0, max_batch=2, max_delay_ms=1)
    try:
        for body in (b"not a cloud", _npy_bytes(np.zeros((4, 2), np.float32))):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(url, body)
            assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, json.dumps({"points": [[1.0, 2.0]]}).encode(), "application/json")
        assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url, _npy_bytes(np.zeros((4, 3), np.float32)))
        assert e.value.code == 500
        assert "ZeroDivisionError" in json.loads(e.value.read())["error"]
        for route in ("nope", "predict"):  # GET of an unknown route, or of /predict
            with pytest.raises(urllib.error.HTTPError) as e:
                with urllib.request.urlopen(f"{url}/{route}", timeout=60):
                    pass
            assert e.value.code == 404
        req = urllib.request.Request(f"{url}/healthz", data=b"x", headers={"Content-Type": OCTET})
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 404
    finally:
        shutdown_server(server)


def test_http_stress_concurrent_clients_each_get_their_own_answer():
    """16 clients x 8 requests against a fn with a 20 ms dispatch (long
    beside the handlers' parsing, so requests queue behind each batch even on
    a loaded host): every reply is its own cloud's checksum, and the batcher
    coalesces (mean batch above 1.5)."""
    def fn(batch):
        time.sleep(0.02)
        return _checksum(batch)

    server, url = _start(fn, max_batch=16, max_delay_ms=10)
    n_clients, n_reqs = 16, 8
    errs = []

    def client(ci):
        rng = np.random.default_rng(ci)
        for ri in range(n_reqs):
            cloud = rng.standard_normal((8, 3)).astype(np.float32)
            try:
                r = _post(url, _npy_bytes(cloud))
                np.testing.assert_allclose(r["probs"][0], cloud.sum(), rtol=1e-4)
            except Exception as e:  # noqa: BLE001 - collected for the assert
                errs.append((ci, ri, repr(e)))

    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errs, errs[:5]
        b = server.RequestHandlerClass.batcher
        assert b.n_requests == n_clients * n_reqs
        assert b.mean_batch_size > 1.5, (b.mean_batch_size, b.n_batches)
    finally:
        shutdown_server(server)


def test_http_malformed_n_isolated_from_good_traffic():
    """A request with an N the batch function refuses gets its own 500 while
    concurrent good requests are answered: the batcher never mixes Ns."""
    good_n = 16

    def fn(batch):  # the Predictor's strict-N contract
        if batch.shape[1] != good_n:
            raise ValueError(f"request has {batch.shape[1]} points but the predictor "
                             f"accepts ({good_n},)")
        return _checksum(batch)

    server, url = _start(fn, max_batch=8, max_delay_ms=20)
    results, codes = {}, {}

    def good(i):
        results[i] = _post(url, _npy_bytes(np.full((good_n, 3), float(i + 1), np.float32)))

    def bad():
        try:
            _post(url, _npy_bytes(np.zeros((good_n + 1, 3), np.float32)))
            codes["bad"] = 200
        except urllib.error.HTTPError as e:
            codes["bad"], codes["msg"] = e.code, json.loads(e.read())["error"]

    try:
        threads = [threading.Thread(target=good, args=(i,)) for i in range(4)]
        threads.append(threading.Thread(target=bad))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert codes["bad"] == 500 and "ValueError" in codes["msg"]
        for i in range(4):
            np.testing.assert_allclose(results[i]["probs"][0], good_n * 3 * (i + 1), rtol=1e-4)
    finally:
        shutdown_server(server)


def test_http_oversized_or_empty_body_rejected():
    """A Content-Length past MAX_BODY, or of 0, answers 400 before any body
    is read."""
    server, _ = _start(lambda b: b.sum(axis=(1, 2))[:, None], max_batch=2, max_delay_ms=1)
    try:
        host, port = server.server_address
        for length, body in ((MAX_BODY + 1, b"\x93NUMPY"), (0, b"")):
            with socket.create_connection((host, port), timeout=30) as s:
                s.sendall((f"POST /predict HTTP/1.1\r\nHost: {host}\r\nContent-Type: {OCTET}\r\n"
                           f"Content-Length: {length}\r\n\r\n").encode() + body)
                reply = b""
                while chunk := s.recv(4096):  # the server closes after the reply
                    reply += chunk
                reply = reply.decode()
            assert "400" in reply.split("\r\n")[0], reply
            assert f"bad Content-Length {length}" in reply
    finally:
        shutdown_server(server)


def test_main_refuses_an_orbax_directory(tmp_path):
    orbax_dir = tmp_path / "ckpt-best"
    orbax_dir.mkdir()
    with pytest.raises(NotImplementedError, match="export_torch"):
        serve_http.main(["--ckpt", str(orbax_dir), "--device", "cpu"])


def test_http_with_a_real_predictor_matches_predict_proba_and_jax(tmp_path):
    """A 2-block classifier with JAX's initial weights, carried over by
    ``state_dict_from_jax`` and loaded from a ``.pth`` the way ``main`` loads
    it, served on the CPU: each reply's probs equal the port's
    ``predict_proba`` of that cloud within 1e-6 and the JAX package's server's
    within 1e-4, with the same label."""
    import jax
    import jax.numpy as jnp

    from si_mamba_tpu.models import PointMamba as JPointMamba
    from si_mamba_tpu.models import PointMambaConfig as JConfig
    from si_mamba_tpu.serve_http import make_server as j_make_server
    from si_mamba_tpu.serve_http import shutdown_server as j_shutdown_server
    from si_mamba_tpu.serving import Predictor as JPredictor
    from si_mamba_tpu_torch.serving import Predictor
    from si_mamba_tpu_torch.utils.weights import state_dict_from_jax

    cfg = dict(trans_dim=32, depth=2, cls_dim=4, group_size=8, num_group=16, encoder_dims=32,
               knn_graph=4, drop_path=0.0, method="MAMBA")
    jmodel = JPointMamba(JConfig(**cfg))
    variables = jax.jit(lambda k: jmodel.init(k, jnp.zeros((2, 128, 3)), train=False))(
        jax.random.key(0))
    pth = tmp_path / "small.pth"
    torch.save({"base_model": state_dict_from_jax(variables["params"],
                                                  variables["batch_stats"])}, pth)
    pred = Predictor.from_checkpoint(str(pth), model_cfg=cfg, npoints=128, max_batch=4,
                                     device="cpu")
    jpred = JPredictor(model=jmodel, variables=variables, npoints=128, max_batch=4)
    clouds = np.random.default_rng(5).standard_normal((3, 128, 3)).astype(np.float32)
    server, url = _start(pred.predict_proba, max_batch=4, max_delay_ms=10)
    jserver, jurl = _start(jpred.predict_proba, make=j_make_server, max_batch=4,
                           max_delay_ms=10)
    try:
        got = [_post(url, _npy_bytes(c)) for c in clouds]
        jgot = [_post(jurl, _npy_bytes(c)) for c in clouds]
    finally:
        shutdown_server(server)
        j_shutdown_server(jserver)
    for i, (r, j) in enumerate(zip(got, jgot)):
        want = pred.predict_proba(clouds[i:i + 1])[0]
        np.testing.assert_allclose(r["probs"], want, rtol=0, atol=1e-6)
        assert r["label"] == int(want.argmax()) == j["label"]
        np.testing.assert_allclose(r["probs"], j["probs"], rtol=0, atol=1e-4)
