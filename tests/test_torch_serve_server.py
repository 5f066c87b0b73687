"""The port's HTTP server (nanodiloco_tpu_torch/serve/server.py) over a
REAL socket on the CPU, and the ``generate`` / ``serve`` subcommands of
``python -m nanodiloco_tpu_torch`` on a checkpoint the port's train()
wrote: the served tokens are the tokens ``generate()`` gives (both run
float32 on the CPU: identity, not a tolerance). The 400 / 429 / 503
cases are the JAX package's tests/test_serve.py ones. The CLI also serves
from a paged int8 arena with speculation and hot-swaps a checkpoint
through POST /admin/swap; ``--tp 2`` raises."""

import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from nanodiloco_tpu_torch import __main__ as cli
from nanodiloco_tpu_torch.models.config import LlamaConfig
from nanodiloco_tpu_torch.models.generate import generate
from nanodiloco_tpu_torch.models.llama import init_params
from nanodiloco_tpu_torch.obs.telemetry import parse_metrics_text
from nanodiloco_tpu_torch.serve import (
    InferenceEngine,
    Scheduler,
    ServeServer,
    http_get,
    http_post_json,
)
from nanodiloco_tpu_torch.training.train_loop import TrainConfig, train

ROOT = Path(__file__).resolve().parents[1]
CFG = LlamaConfig(vocab_size=128, hidden_size=64, intermediate_size=128,
                  num_attention_heads=4, num_key_value_heads=2, num_hidden_layers=2,
                  max_position_embeddings=64)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return init_params(torch.Generator().manual_seed(0), CFG, device="cpu")


def _post(port, doc, path="/v1/generate", timeout=60.0):
    return http_post_json(f"http://127.0.0.1:{port}{path}", doc, timeout=timeout)


def _get(port, path, timeout=10.0):
    return http_get(f"http://127.0.0.1:{port}{path}", timeout=timeout)


def _server(params, **kw):
    eng = InferenceEngine(params, CFG, device="cpu", **{"num_slots": 2, "max_len": 32, **kw})
    return ServeServer(Scheduler(eng), port=0, host="127.0.0.1",
                       request_timeout_s=120.0).start()


def test_generate_endpoint_over_real_socket(params):
    """Three overlapping requests from concurrent client threads: each
    equals solo generate() with its seed, request ids are echoed, serve
    gauges and histograms land on /metrics, /healthz is 200."""
    srv = _server(params)
    try:
        doc = {"token_ids": [5, 9, 2, 11], "max_new_tokens": 6, "temperature": 0.8,
               "top_k": 20, "stop": False}
        results: dict[int, tuple] = {}

        def client(i, seed):
            extra = {"request_id": "client-0-xyz"} if i == 0 else {}
            results[i] = _post(srv.port, {**doc, **extra, "seed": seed})

        threads = [threading.Thread(target=client, args=(i, s))
                   for i, s in enumerate((7, 7, 21))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        for i, seed in enumerate((7, 7, 21)):
            code, out = results[i]
            assert code == 200, out
            assert out["finish_reason"] == "length"
            want = generate(params, [doc["token_ids"]], CFG, 6, temperature=0.8, top_k=20,
                            seed=seed, device="cpu")[0].tolist()
            assert out["token_ids"] == want
            assert out["timing"]["ttft_s"] > 0
        assert results[0][1]["token_ids"] != results[2][1]["token_ids"]
        assert results[0][1]["request_id"] == "client-0-xyz"
        auto_ids = {results[i][1]["request_id"] for i in (1, 2)}
        assert len(auto_ids) == 2 and all(r.startswith("req-") for r in auto_ids)

        code, body = _get(srv.port, "/metrics")
        assert code == 200 and body.rstrip().endswith("# EOF")
        m = parse_metrics_text(body)
        assert m['nanodiloco_serve_requests_total{outcome="served"}'] == 3
        assert m["nanodiloco_serve_slots_total"] == 2
        assert m["nanodiloco_serve_queue_depth"] == 0
        assert m["nanodiloco_serve_tokens_total"] >= 18
        assert m["nanodiloco_serve_ttft_histogram_seconds_count"] == 3
        assert m['nanodiloco_serve_ttft_histogram_seconds_bucket{le="+Inf"}'] == 3
        assert m["nanodiloco_serve_decode_tick_seconds_count"] > 0
        code, body = _get(srv.port, "/healthz")
        assert code == 200
        health = json.loads(body)
        assert health["healthy"] and health["served"] == 3
        assert _get(srv.port, "/nope")[0] == 404
    finally:
        srv.stop()


def test_server_rejects_bad_requests_with_400(params):
    srv = _server(params, num_slots=1, max_len=16)
    try:
        for bad in (
            {},
            {"prompt": "hi"},                              # no tokenizer
            {"token_ids": []},
            {"token_ids": [1], "max_new_tokens": 0},
            {"token_ids": [1], "max_new_tokens": None},
            {"token_ids": [1], "temperature": "hot"},
            {"token_ids": [1], "temperature": -1.0},
            {"token_ids": [1], "top_p": 0.0},
            {"token_ids": [1] * 15, "max_new_tokens": 10},  # > max_len
            {"token_ids": [CFG.vocab_size + 1]},           # out of vocab
            {"token_ids": [1], "request_id": ""},
            {"token_ids": [1], "request_id": 7},
            {"token_ids": [1], "request_id": "x" * 200},
            {"token_ids": [1], "speculate": "yes"},
        ):
            code, out = _post(srv.port, bad)
            assert code == 400, (bad, out)
            assert "error" in out
    finally:
        srv.stop()


@pytest.mark.parametrize("path, doc, code, match", [
    ("/admin/swap", {"checkpoint_dir": "x"}, 404, "no swap loader"),
    ("/admin/kv/export", {"request_id": "r"}, 404, "no parked stream"),
    ("/admin/kv/import", {}, 400, "version"),
])
def test_admin_engine_calls_answer(params, path, doc, code, match):
    """The endpoints that reach swap_weights, export_kv and import_kv
    answer as the JAX package's server does: a server built without a
    swap loader 404s a swap, an unknown request id 404s an export, a
    malformed ship payload 400s."""
    srv = _server(params)
    try:
        got, out = _post(srv.port, doc, path=path)
        assert got == code, out
        assert match in out["error"]
    finally:
        srv.stop()


def test_queue_full_returns_429():
    """Backpressure over the wire: a gated fake backend holds the only
    slot; with max_queue=1 the second waiting request is answered 429
    while the first completes."""

    class GatedBackend:
        num_slots = 1

        def __init__(self):
            self.gate = threading.Event()
            self.seed = None

        def start_prefill(self, slot, request):
            self._staged = request.seed
            return 1

        def prefill_step(self, slot):
            self.seed = self._staged
            return 1

        def step(self):
            self.gate.wait(30)
            return [2]

        def release(self, slot):
            self.seed = None

    backend = GatedBackend()
    srv = ServeServer(Scheduler(backend, max_queue=1), port=0, host="127.0.0.1",
                      request_timeout_s=60.0).start()
    try:
        codes: dict[int, int] = {}

        def client(i):
            codes[i], _ = _post(srv.port, {"token_ids": [1], "max_new_tokens": 2, "seed": i})

        t0 = threading.Thread(target=client, args=(0,))
        t0.start()
        for _ in range(500):
            if backend.seed is not None:
                break
            time.sleep(0.01)
        t1 = threading.Thread(target=client, args=(1,))
        t1.start()
        for _ in range(500):
            if json.loads(_get(srv.port, "/healthz")[1])["queue_depth"] >= 1:
                break
            time.sleep(0.01)
        code2, out2 = _post(srv.port, {"token_ids": [1], "max_new_tokens": 2, "seed": 2})
        assert code2 == 429, out2
        assert "full" in out2["error"]
        backend.gate.set()
        t0.join(timeout=60)
        t1.join(timeout=60)
        assert not t0.is_alive() and not t1.is_alive()
        assert codes[0] == 200 and codes[1] == 200
        m = parse_metrics_text(_get(srv.port, "/metrics")[1])
        assert m['nanodiloco_serve_requests_total{outcome="rejected"}'] >= 1
    finally:
        backend.gate.set()
        srv.stop()


def test_healthz_flips_503_when_the_loop_dies():
    class DoomedBackend:
        num_slots = 1

        def start_prefill(self, slot, request):
            return 1

        def prefill_step(self, slot):
            return 1

        def step(self):
            raise RuntimeError("device lost")

        def release(self, slot):
            pass

    srv = ServeServer(Scheduler(DoomedBackend()), port=0, host="127.0.0.1",
                      request_timeout_s=2.0).start()
    try:
        assert _get(srv.port, "/healthz")[0] == 200
        code, _ = _post(srv.port, {"token_ids": [1], "max_new_tokens": 3, "seed": 0},
                        timeout=30)
        assert code == 504
        for _ in range(500):
            if _get(srv.port, "/healthz")[0] == 503:
                break
            time.sleep(0.01)
        code, body = _get(srv.port, "/healthz")
        assert code == 503
        assert "device lost" in json.loads(body).get("error", "")
    finally:
        srv.stop()


# -- the CLI subcommands on a port checkpoint --------------------------------


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """One round of the port's train() on the CPU with a checkpoint: its
    sidecar names the byte-level tokenizer (None)."""
    root = tmp_path_factory.mktemp("ck")
    model = LlamaConfig(vocab_size=384, hidden_size=64, intermediate_size=128,
                        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2)
    train(TrainConfig(seed=0, batch_size=2, per_device_batch_size=2, seq_length=32,
                      warmup_steps=1, total_steps=2, inner_steps=2, num_workers=1, model=model,
                      checkpoint_dir=str(root / "ck"), log_dir=str(root / "runs"),
                      run_name="r", quiet=True), device="cpu")
    return root / "ck"


def test_restore_raw_loads_the_snapshot_alone(checkpoint):
    from nanodiloco_tpu_torch.training.checkpoint import CheckpointManager

    ck = CheckpointManager(str(checkpoint))
    snap = ck.restore_raw(only={"snapshot"})
    assert set(snap) == {"snapshot"}
    assert snap["snapshot"]["embed"].shape == (384, 64)
    assert set(ck.restore_raw()) >= {"params", "snapshot", "inner_opt_state"}
    with pytest.raises(KeyError, match="no field"):
        ck.restore_raw(only={"nope"})


def test_cli_generate_and_serve_agree(checkpoint, capsys):
    """``generate`` prints the prompt and its greedy continuation;
    ``serve`` in a subprocess answers POST /v1/generate over a socket
    with the tokens generate() gives, and answers /healthz and /metrics;
    a sidecar naming a tokenizer the port lacks is a readable SystemExit."""
    model_cfg, _, snap = cli._load_checkpoint_snapshot(str(checkpoint), None)
    want = generate(snap, [list(b"Hello")], model_cfg, 6, device="cpu")[0].tolist()
    texts = cli.generate_main(
        ["--checkpoint-dir", str(checkpoint), "--prompt", "Hello", "--max-new-tokens", "6",
         "--temperature", "0", "--no-stop-at-eos", "--device", "cpu"])
    assert texts[0].startswith("Hello") and capsys.readouterr().out.startswith("Hello")

    env = {**os.environ, "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "nanodiloco_tpu_torch", "serve", "--checkpoint-dir",
         str(checkpoint), "--device", "cpu", "--host", "127.0.0.1", "--slots", "2",
         "--max-len", "64", "--chunk-size", "8"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving"), line + proc.stdout.read()
        port = int(line.split(" on ")[1].split()[0].rsplit(":", 1)[1])
        code, out = _post(port, {"prompt": "Hello", "max_new_tokens": 6, "stop": False})
        assert code == 200, out
        assert out["token_ids"] == want and out["text"] == texts[0][len("Hello"):]
        assert _get(port, "/healthz")[0] == 200
        code, body = _get(port, "/metrics")
        assert code == 200
        assert parse_metrics_text(body)['nanodiloco_serve_requests_total{outcome="served"}'] == 1
    finally:
        proc.terminate()
        assert proc.wait(timeout=60) == 0

    side = json.loads((checkpoint / "model_config.json").read_text())
    bad = checkpoint.parent / "bad"
    bad.mkdir()
    os.symlink(next(checkpoint.glob("step_*.pt")), bad / "step_2.pt")
    (bad / "model_config.json").write_text(json.dumps({**side, "tokenizer": "gpt2"}))
    with pytest.raises(SystemExit, match="tokenizer 'gpt2' is not available"):
        cli.main(["generate", "--checkpoint-dir", str(bad), "--device", "cpu"])


def test_cli_serve_paged_int8_spec_and_admin_swap(checkpoint):
    """``serve --kv-block-size 4 --kv-dtype int8 --spec-k 2`` answers with
    the tokens an engine of those settings gives; POST /admin/swap of a
    checkpoint (the serve CLI wires the loader) swaps it in and the next
    request still answers; ``--tp 2`` raises NotImplementedError naming
    ROADMAP."""
    from nanodiloco_tpu_torch.serve import GenRequest

    model_cfg, _, snap = cli._load_checkpoint_snapshot(str(checkpoint), None)
    eng = InferenceEngine(snap, model_cfg, num_slots=2, max_len=64, chunk_size=8,
                          kv_block_size=4, kv_dtype="int8", spec_k=2, device="cpu")
    eng.warm_spec()
    sched = Scheduler(eng)
    ticket = sched.submit(GenRequest(prompt=tuple(b"Hello Hello"), max_new_tokens=8))
    while not ticket.done():
        sched.tick()
    want = ticket.result["tokens"]
    env = {**os.environ, "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "nanodiloco_tpu_torch", "serve", "--checkpoint-dir",
         str(checkpoint), "--device", "cpu", "--host", "127.0.0.1", "--slots", "2",
         "--max-len", "64", "--chunk-size", "8", "--kv-block-size", "4", "--kv-dtype", "int8",
         "--spec-k", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
    try:
        line = proc.stdout.readline()
        assert line.startswith("serving"), line + proc.stdout.read()
        port = int(line.split(" on ")[1].split()[0].rsplit(":", 1)[1])
        doc = {"prompt": "Hello Hello", "max_new_tokens": 8, "stop": False}
        code, out = _post(port, doc)
        assert code == 200 and out["token_ids"] == want, out
        code, out = _post(port, {"checkpoint_dir": str(checkpoint)}, path="/admin/swap")
        assert code == 200 and out["deploy_generation"] == 1, out
        code, out = _post(port, doc)
        assert code == 200 and out["token_ids"] == want, out
        metrics = parse_metrics_text(_get(port, "/metrics")[1])
        assert metrics["nanodiloco_kv_blocks_free"] > 0
    finally:
        proc.terminate()
        assert proc.wait(timeout=60) == 0
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(["serve", "--checkpoint-dir", str(checkpoint), "--device", "cpu", "--tp", "2"])
