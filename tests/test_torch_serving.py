"""The port's ServingEngine against the JAX package's on the same requests
and the same (bridged) weights: token streams must be identical in
monolithic and chunked prefill, at dispatch depth 0 and 2, and under an
undersized page pool that forces preemption and recompute."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from repro.runtime import serving as jserving  # noqa: E402
from repro_torch.core.dispatch import DispatchQueue  # noqa: E402
from repro_torch.runtime import serving as tserving  # noqa: E402
from repro_torch.runtime.serving import chunking  # noqa: E402

from test_torch_model import TINY, bridged  # noqa: E402


@pytest.fixture(scope="module")
def models():
    return bridged(TINY)


def _requests(mod, lens, gens, seed=0):
    rng = np.random.default_rng(seed)
    return [mod.Request(uid=i, prompt=rng.integers(0, TINY.vocab, n),
                        max_new_tokens=g)
            for i, (n, g) in enumerate(zip(lens, gens))]


def _serve(models, lens, gens, **cfg):
    jm, jp, tm, tp = models
    outs, stats = [], []
    for mod, model, params in ((jserving, jm, jp), (tserving, tm, tp)):
        eng = mod.ServingEngine(model, TINY if mod is jserving else tm.cfg,
                                params, config=mod.EngineConfig(**cfg))
        for r in _requests(mod, lens, gens):
            eng.submit(r)
        outs.append(eng.run(max_steps=2000))
        stats.append(eng.scheduler.stats)
    return outs, stats


def _assert_same(outs):
    want, got = outs
    assert sorted(want) == sorted(got)
    for uid in want:
        np.testing.assert_array_equal(got[uid], np.asarray(want[uid]),
                                      err_msg=f"request {uid}")


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("chunks", [None, (4, 8)])
def test_engine_streams_match_jax(models, depth, chunks):
    """Staggered admission (slots < requests), mixed prompt/gen lengths."""
    outs, stats = _serve(models, (5, 9, 7, 12), (8, 6, 10, 7), max_slots=2,
                         max_seq=64, depth=depth, prefill_chunks=chunks)
    _assert_same(outs)
    assert {k: stats[0][k] for k in stats[1]} == stats[1]


@pytest.mark.parametrize("chunks", [None, (4, 8)])
def test_engine_preemption_recompute_matches_jax(models, chunks):
    """--page-size 4 --pages 14: the pool cannot hold two grown requests,
    so the youngest is preempted and recomputed — identically in both."""
    outs, stats = _serve(models, (20, 15, 20, 15, 20), (12,) * 5,
                         max_slots=2, max_seq=64, depth=2, page_size=4,
                         num_pages=14, prefill_chunks=chunks)
    _assert_same(outs)
    assert stats[1]["preempted"] > 0
    assert {k: stats[0][k] for k in stats[1]} == stats[1]


def test_engine_rejects_unported_options(models):
    *_, tm, tp = models
    with pytest.raises(ValueError, match="unknown kv_format"):
        tserving.EngineConfig(kv_format="int7")
    with pytest.raises(TypeError):          # no counterpart: in place
        tserving.EngineConfig(donate=True)
    with pytest.raises(ValueError, match="chunked prefill"):
        tserving.EngineConfig(prefix_sharing=True)
    eng = tserving.ServingEngine(tm, tm.cfg, tp,
                                 config=tserving.EngineConfig(max_seq=32))
    with pytest.raises(ValueError):
        eng.submit(tserving.Request(uid=1, prompt=np.arange(40),
                                    max_new_tokens=2))


@pytest.mark.parametrize("plen", [1, 31, 32, 33, 100])
def test_chunk_plan_copy_matches_reference(plen):
    from repro.runtime.serving import chunking as jchunking
    assert chunking.chunk_plan(plen) == jchunking.chunk_plan(plen)
    assert chunking.chunk_plan(plen, (4, 8)) == jchunking.chunk_plan(plen,
                                                                     (4, 8))


@pytest.mark.parametrize("depth", [0, 1, 3])
def test_dispatch_queue_lags_readback(depth):
    """Every submitted step's vector comes back intact, in order, with at
    most ``depth`` steps outstanding in the queue."""
    state = {"n": 0}

    def step():
        state["n"] += 1
        return torch.full((3,), state["n"])

    q = DispatchQueue(depth=depth)
    reads = [q.submit(step) for _ in range(6)]
    assert len(q._inflight) == min(depth, 6)
    q.drain()
    assert [int(r.wait()[0]) for r in reads] == [1, 2, 3, 4, 5, 6]


def test_serve_cli_runs_on_cpu(capsys):
    from repro_torch.launch import serve
    assert serve.main(["--arch", "llama3.2-3b", "--device", "cpu",
                       "--requests", "3", "--prompt-len", "12", "--gen", "4",
                       "--slots", "2", "--prefill-mode", "chunked",
                       "--chunk-buckets", "4,8"]) == 0
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out
    assert "prefix cache" not in out
    assert serve.main(["--arch", "llama3.2-3b", "--device", "cpu",
                       "--requests", "3", "--prompt-len", "20", "--gen", "4",
                       "--slots", "3", "--prefill-mode", "chunked",
                       "--chunk-buckets", "4,8", "--page-size", "4",
                       "--prompt-mix", "shared-prefix",
                       "--prefix-sharing"]) == 0
    out = capsys.readouterr().out
    assert "3 requests, 12 tokens" in out
    assert "prefix cache: forks=2 shared_prompt_tokens=16" in out
    with pytest.raises(SystemExit):
        serve.parse_args(["--arch", "llama3.2-3b", "--prefix-sharing"])
    assert serve.parse_args(["--arch", "llama3.2-3b",
                             "--no-reduced"]).reduced is False
    assert serve.parse_args(["--arch", "llama3.2-3b"]).reduced is True
    # the robustness flags: a fault plan seeded by --seed, the ladder, a
    # deadline (the robustness line and the transitions), then replicas
    # behind the router under each placement (one line a replica), the
    # streams equal the bare engine's
    base = ["--arch", "llama3.2-3b", "--device", "cpu", "--requests", "4",
            "--prompt-len", "12", "--gen", "6", "--slots", "2",
            "--prefill-mode", "chunked", "--chunk-buckets", "4,8"]
    assert serve.main(base + ["--fault-plan", "decode:0.6:3,alloc:0.2",
                              "--health", "--deadline-ms", "600000",
                              "--seed", "5"]) == 0
    out = capsys.readouterr().out
    assert "robustness: health=" in out and "timed_out=0" in out
    assert "health step" in out and "-> DEGRADED (consecutive-faults)" in out
    args = serve.parse_args(base + ["--fault-plan", "logits:0.5",
                                    "--deadline-ms", "5"])
    config = serve.engine_config(args, [12])
    assert config.faults.seed == 0 and config.health is None
    assert config.faults.spec("logits").rate == 0.5
    assert [r.deadline_ms for r in serve.requests(args, 256)] == [5.0] * 4
    bundle, params = serve.build(serve.parse_args(base))
    _, want, _ = serve.serve(bundle, params, serve.parse_args(base))
    for placement in ("least-pressure", "round-robin", "affinity"):
        fleet_args = base + ["--replicas", "2", "--placement", placement]
        assert serve.main(fleet_args) == 0
        out = capsys.readouterr().out
        assert f"4 requests over 2 replicas ({placement}), 24 tokens" in out
        assert out.count("  replica: {'replica': ") == 2
        fleet, got, _ = serve.serve_fleet(bundle, params,
                                          serve.parse_args(fleet_args))
        assert sorted(got) == sorted(want)
        for uid in want:
            np.testing.assert_array_equal(got[uid], want[uid])
    with pytest.raises(SystemExit):
        serve.parse_args(base + ["--replicas", "0"])
    with pytest.raises(SystemExit):
        serve.parse_args(base + ["--placement", "random"])

