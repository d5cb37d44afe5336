"""cldrd_tpu_torch.cli.serve on the CPU (``--device cpu``, port 0), in
flat, IVF and IVFPQ + refine modes, with a tiny model loaded from a
``.pth.tar`` checkpoint made from the JAX package's own initialisation.

Every served answer must equal the port's direct ``index.search`` of the
service's own query embeddings, and the JAX package's index over the same
artifacts searched with those embeddings (tests/test_cli.py's serve tests
are the model)."""
import contextlib
import json
import sys
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cldrd_tpu.index import DiskRefiner as JDiskRefiner
from cldrd_tpu.index import IVFIndex as JIVF
from cldrd_tpu.index import RefinedIndex as JRefined
from cldrd_tpu.index import load_index as j_load_index
from cldrd_tpu.models import DistilBertConfig as JaxConfig
from cldrd_tpu.models import NwayDualEncoder as JaxDualEncoder
from cldrd_tpu.models.hf_loader import dual_encoder_flax_to_torch
from cldrd_tpu_torch.cli import index as t_index
from cldrd_tpu_torch.cli import serve as t_serve
from cldrd_tpu_torch.index import IVFIndex, load_index

QUERIES = ["find subject3 info", "find subject7 info"]


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A 96-passage collection (tests/test_cli.py's corpus), one shared
    checkpoint, and the port's index CLI's stores: flat fp32 with an IVF
    companion, flat int8 with an int8 IVF companion, and flat fp32 with
    an IVFPQ companion."""
    tmp = tmp_path_factory.mktemp("serve")
    rng = np.random.default_rng(0)
    lines, pid = [], 0
    for q in range(16):
        lines.append(f"{pid}\tdocument with subject{q} info inside\n")
        pid += 1
        for _ in range(5):
            lines.append(f"{pid}\tnoise {rng.integers(10**6)} text "
                         f"{rng.integers(10**6)}\n")
            pid += 1
    passages = str(tmp / "passages.tsv")
    with open(passages, "w") as f:
        f.write("".join(lines))
    model = JaxDualEncoder(config=JaxConfig.tiny())
    dq = {"input_ids": jnp.zeros((1, 8), jnp.int32),
          "attention_mask": jnp.ones((1, 8), jnp.int32)}
    dp = {"input_ids": jnp.zeros((1, 1, 8), jnp.int32),
          "attention_mask": jnp.ones((1, 1, 8), jnp.int32)}
    params = model.init(jax.random.PRNGKey(11), dq, dp)["params"]
    sd = dual_encoder_flax_to_torch(jax.tree_util.tree_map(np.asarray,
                                                           params))
    ckpt = str(tmp / "checkpoint_1.pth.tar")
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v))
                               for k, v in sd.items()}}, ckpt)
    common = ["--collection", passages, "--checkpoint", ckpt,
              "--model-size", "tiny", "--tokenizer", "hash",
              "--max-length", "16", "--batch-size", "32",
              "--compute-dtype", "float32", "--device", "cpu",
              "--ivf-nlist", "4", "--ivf-slot", "128", "--ivf-nprobe", "2"]
    dirs = {name: str(tmp / name) for name in ("fp32", "int8", "pq")}
    with contextlib.redirect_stdout(None):
        assert t_index.main([*common, "--out", dirs["fp32"]]) == 0
        assert t_index.main([*common, "--out", dirs["int8"],
                             "--store-dtype", "int8"]) == 0
        assert t_index.main([*common, "--out", dirs["pq"], "--pq-m", "8"]) \
            == 0
    return {"ckpt": ckpt, "tmp": tmp, **dirs}


@contextlib.contextmanager
def _daemon(artifacts, index_dir, *extra):
    args = t_serve.build_parser().parse_args([
        "--index", index_dir, "--port", "0", "--checkpoint",
        artifacts["ckpt"], "--model-size", "tiny", "--tokenizer", "hash",
        "--max-length", "12", "--passage-max-length", "16",
        "--encode-batch-size", "8", "--topk", "5", "--device", "cpu",
        *extra])
    httpd = t_serve.serve(args)
    svc = httpd.RequestHandlerClass.service
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        yield svc, url
    finally:
        svc.close()
        httpd.shutdown()
        httpd.server_close()
        th.join(timeout=30)
        assert not th.is_alive()


# the daemons answer on localhost: no proxy from the environment
_HTTP = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _get(url, path):
    with _HTTP.open(url + path, timeout=60) as r:
        return json.loads(r.read())


def _post(url, path, payload):
    req = urllib.request.Request(url + path, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with _HTTP.open(req, timeout=120) as r:
        return json.loads(r.read())


def _status(url, path, payload):
    try:
        _post(url, path, payload)
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers)
    return 200, {}


def _service_embeddings(svc, texts):
    tokens = svc._pad(svc.tokenizer(texts, svc.max_length), svc.encode_batch)
    return svc.encode_fn(tokens)[: len(texts)].float().numpy()


def _ids(ranked):
    return [[h["id"] for h in r] for r in ranked]


def _check_direct(got, scores_ids):
    scores, ids = scores_ids
    for r, ranked in enumerate(got):
        valid = ids[r] >= 0
        assert [h["id"] for h in ranked] == ids[r][valid].tolist()
        assert [h["score"] for h in ranked] == \
            [float(s) for s in scores[r][valid]]


def test_serve_flat(artifacts):
    with _daemon(artifacts, artifacts["fp32"], "--hbm-dtype",
                 "float32") as (svc, url):
        health = _get(url, "/healthz")
        assert health["ok"] and health["n_vectors"] == 96
        assert health["dim"] == 32 and "nprobe" not in health
        got = _post(url, "/search", {"queries": QUERIES, "k": 5})["results"]
        embs = _service_embeddings(svc, QUERIES)
        _check_direct(got, svc.index.search(embs, 5))
        jflat = j_load_index(artifacts["fp32"], dtype=jnp.float32)
        assert _ids(got) == jflat.search(embs, 5)[1].tolist()
        for ranked in got:
            scores = [h["score"] for h in ranked]
            assert scores == sorted(scores, reverse=True)

        # exclusion by over-fetch; k + exclusions above --topk is refused
        top2 = [h["id"] for h in got[0][:2]]
        ex = _post(url, "/search", {"queries": QUERIES[:1], "k": 3,
                                    "exclude_ids": top2})["results"][0]
        assert [h["id"] for h in ex] == [h["id"] for h in got[0][2:5]]
        for bad in ({"queries": QUERIES, "k": 6},
                    {"queries": QUERIES, "k": 5, "exclude_ids": [1]},
                    {"queries": "not-a-list"},
                    {"queries": QUERIES, "rerank_k": 5}):
            assert _status(url, "/search", bad)[0] == 400
        code, _ = _status(url, "/rerank", {"query": "q", "passages": ["p"]})
        assert code == 400
        svc.max_pending = 0                     # backpressure
        code, headers = _status(url, "/search", {"queries": QUERIES})
        assert code == 503 and headers["Retry-After"] == "1"
        svc.max_pending = 256

        # /add, /remove, /save, /reload
        n0 = svc.index.n_vectors
        out = _post(url, "/add", {"ids": [9000, 9001], "texts": [
            "find zebra info inside", "find yak info inside"]})
        assert out["ok"] and out["n_vectors"] == n0 + 2
        top1 = got[0][0]["id"]
        assert _post(url, "/remove", {"ids": [top1]})["n_vectors"] == n0 + 1
        hits = _post(url, "/search", {"queries": QUERIES[:1]})["results"][0]
        assert top1 not in [h["id"] for h in hits]
        snap = str(artifacts["tmp"] / "flat_snapshot")
        assert _post(url, "/save", {"dir": snap})["n_vectors"] == n0 + 1
        host = j_load_index(snap)._host_ids().tolist()  # the JAX package
        assert {9000, 9001} <= set(host) and top1 not in host
        _post(url, "/remove", {"ids": [9000]})
        assert _post(url, "/reload", {"dir": snap})["n_vectors"] == n0 + 1
        assert 9000 in svc.index._host_ids().tolist()
        assert _status(url, "/reload",
                       {"dir": str(artifacts["tmp"] / "nope")})[0] == 400
        assert _status(url, "/add", {"ids": [1], "texts": []})[0] == 400
        assert svc.index.n_vectors == n0 + 1


def test_serve_coalesces_concurrent_clients(artifacts):
    """More clients than cores, with a short thread switch interval: every
    request is answered as it is alone, none is lost from the counters,
    and the requests share device passes."""
    with _daemon(artifacts, artifacts["fp32"], "--hbm-dtype", "float32",
                 "--max-batch-wait-ms", "250") as (svc, url):
        n = 16
        texts = [f"find subject{q} info" for q in range(n)]
        alone = {t: svc._search_device([t], 5)[0] for t in texts}
        before = dict(svc.stats)
        out = {}

        def one(i):
            out[i] = _post(url, "/search", {"queries": [texts[i]],
                                            "k": 3 if i % 2 else 5})
        threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
        finally:
            sys.setswitchinterval(interval)
        assert not any(th.is_alive() for th in threads)
        for i, t in enumerate(texts):
            assert out[i]["results"][0] == alone[t][: 3 if i % 2 else 5]
        assert svc.stats["requests"] - before["requests"] == n
        assert svc.stats["queries"] - before["queries"] == n
        assert svc.stats["device_batches"] - before["device_batches"] < n
        health = _get(url, "/healthz")
        assert health["latency_p99_ms"] >= health["latency_p50_ms"] > 0


@pytest.mark.parametrize("store,hbm", [("fp32", "float32"),
                                       ("int8", "int8")])
def test_serve_ivf(artifacts, store, hbm):
    with _daemon(artifacts, artifacts[store], "--ivf", "--hbm-dtype",
                 hbm) as (svc, url):
        health = _get(url, "/healthz")
        assert health["ok"] and health["n_vectors"] == 96
        assert health["nprobe"] == 2 and health["n_buckets"] >= 4
        got = _post(url, "/search", {"queries": QUERIES})["results"]
        embs = _service_embeddings(svc, QUERIES)
        _check_direct(got, svc.index.search(embs, 5))
        jdt = jnp.int8 if hbm == "int8" else jnp.float32
        jivf = JIVF.load(f"{artifacts[store]}/ivf", dtype=jdt)
        assert _ids(got) == jivf.search(embs, 5)[1].tolist()
        # the whole probe: the flat store's exact answer
        svc.index.nprobe = svc.index.n_buckets
        full = _post(url, "/search", {"queries": QUERIES})["results"]
        flat = load_index(artifacts[store], dtype=torch.float32,
                          device="cpu")
        if hbm == "float32":
            assert _ids(full) == flat.search(embs, 5)[1].tolist()
        svc.index.nprobe = 2

        n0 = svc.index.n_vectors
        out = _post(url, "/add", {"ids": [9100, 9101], "texts": [
            "find walrus info inside", "find emu info inside"]})
        assert out["n_vectors"] == n0 + 2
        top1 = got[0][0]["id"]
        assert _post(url, "/remove", {"ids": [top1]})["n_vectors"] == n0 + 1
        hits = _post(url, "/search", {"queries": QUERIES[:1]})["results"][0]
        assert top1 not in [h["id"] for h in hits]
        snap = str(artifacts["tmp"] / f"ivf_snapshot_{store}")
        assert _post(url, "/save", {"dir": snap})["n_vectors"] == n0 + 1
        back = JIVF.load(snap, dtype=jdt)       # the JAX package reads it
        assert back.n_vectors == n0 + 1
        np.testing.assert_array_equal(back._host_ids(),
                                      svc.index._host_ids())
        _post(url, "/remove", {"ids": [9100]})
        assert _post(url, "/reload", {"dir": snap})["n_vectors"] == n0 + 1
        assert svc.index.nprobe == 2
        after = _post(url, "/search", {"queries": QUERIES})["results"]
        _check_direct(after, IVFIndex.load(snap, dtype={
            "int8": torch.int8}.get(hbm, torch.float32),
            device="cpu").search(embs, 5, nprobe=2))


def test_serve_ivfpq_refine(artifacts):
    with _daemon(artifacts, artifacts["pq"], "--ivf", "--nprobe", "3",
                 "--refine-factor", "4") as (svc, url):
        health = _get(url, "/healthz")
        assert health["refine_factor"] == 4 and health["nprobe"] == 3
        got = _post(url, "/search", {"queries": QUERIES})["results"]
        embs = _service_embeddings(svc, QUERIES)
        _check_direct(got, svc.index.search(embs, 5))
        jref = JRefined(JIVF.load(f"{artifacts['pq']}/ivf"),
                        JDiskRefiner(artifacts["pq"]), factor=4)
        assert _ids(got) == jref.search(embs, 5, nprobe=3)[1].tolist()
        out = _post(url, "/add", {"ids": [9200], "texts": ["find yak"]})
        assert out["n_vectors"] == 97
        assert _post(url, "/remove", {"ids": [9200]})["n_vectors"] == 96


@pytest.mark.parametrize("argv", [
    ["--reranker", "distilbert", "--rerank-max-length", "513"],
    ["--passages", "missing.tsv"],
    ["--reranker", "bert", "--reranker-size", "tiny",
     "--rerank-max-length", "65"], ["--shards", "-1"],
    ["--refine-factor", "4"], ["--ivf", "--refine-factor", "0"],
    ["--ivf", "--nprobe", "0"]])
def test_serve_refuses_what_it_does_not_do(artifacts, argv):
    args = t_serve.build_parser().parse_args([
        "--index", artifacts["fp32"], "--model-size", "tiny",
        "--device", "cpu", *argv])
    with pytest.raises(SystemExit):
        t_serve.make_service(args)


def test_entry_points_run_on_cuda_unless_told_otherwise(artifacts):
    """Without --device cpu both CLIs of the slice ask for CUDA and, where
    there is none, raise instead of falling back to the CPU."""
    argv = ["--index", artifacts["int8"], "--model-size", "tiny", "--ivf"]
    assert t_serve.build_parser().parse_args(argv).device == "cuda"
    ivf_argv = ["--collection", "c", "--out", artifacts["int8"],
                "--ivf-only", "--ivf-nlist", "4"]
    assert t_index.build_parser().parse_args(ivf_argv).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_serve.make_service(t_serve.build_parser().parse_args(
                [*argv, "--passage-max-length", "16", "--max-length", "12"]))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_index.main(ivf_argv)
