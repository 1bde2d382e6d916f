"""The port stands alone: it imports neither jax nor the JAX package, a
request for the card without one raises instead of running the plain
versions, and nothing on the CPU path launches a kernel."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch_threads import one_torch_thread  # noqa: E402,F401

from repro_torch.core import device as device_mod  # noqa: E402
from repro_torch.kernels import (conv2d, dotp,  # noqa: E402
                                 flash_attention, flash_decode,
                                 flash_prefill_chunk, matmul, ops, ssd)
from repro_torch.models import registry  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any `import jax` now raises
sys.path.insert(0, {src!r})
sys.path.insert(0, {repo!r})
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in ("runtime.serving.speculative", "runtime.serving.faults",
             "runtime.serving.health", "runtime.serving.replica",
             "runtime.serving.router", "runtime.elastic"):
    assert "repro_torch." + name in names, names
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and (m.split(".")[0] in ("repro", "jax")))
print(len(names), bad)
"""


def test_port_imports_without_jax_or_repro():
    script = _IMPORT_ALL.format(src=os.path.join(REPO, "src"), repo=REPO)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    n, bad = proc.stdout.strip().split(" ", 1)
    assert int(n) >= 20, proc.stdout
    assert bad == "[]", bad


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        device_mod.resolve("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        registry.build("llama3.2-3b", reduced=True)      # default: cuda
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--arch", "llama3.2-3b", "--requests", "1"])


def test_kernel_launchers_refuse_cpu_tensors():
    """The launchers never fall back: CPU operands are an error there (the
    plain version is ops' choice for CPU tensors, not the launcher's)."""
    q, kv = torch.zeros(2, 4, 8), torch.zeros(2, 16, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        flash_decode.launch(q, kv, kv, torch.tensor([3, 4]))
    with pytest.raises(ValueError, match="CUDA"):
        flash_prefill_chunk.launch(torch.zeros(2, 3, 4, 8), kv, kv,
                                   torch.tensor([0, 1]))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.launch(torch.zeros(1, 4, 5, 8),
                               torch.zeros(1, 2, 5, 8),
                               torch.zeros(1, 2, 5, 8))
    with pytest.raises(ValueError, match="CUDA"):
        ssd.launch(torch.zeros(2, 5, 8), torch.zeros(2, 5),
                   torch.zeros(2, 5, 4), torch.zeros(2, 5, 4))
    with pytest.raises(ValueError, match="CUDA"):
        matmul.launch(torch.zeros(3, 4), torch.zeros(4, 5))
    with pytest.raises(ValueError, match="CUDA"):
        dotp.launch(torch.zeros(9), torch.zeros(9))
    with pytest.raises(ValueError, match="CUDA"):
        conv2d.launch(torch.zeros(1, 9, 9, 3), torch.zeros(7, 7, 3, 8))
    with pytest.raises(ValueError, match="devices"):
        ops.flash_decode(q.to("meta"), kv.to("meta"), kv.to("meta"))


def test_cache_constructors_take_no_default_device():
    """Nothing lands on the CPU unasked: both arena constructors need their
    ``device``, and build where they are told."""
    from repro_torch.models import layers, mamba2
    cfg = registry.config("llama3.2-3b").reduced()
    with pytest.raises(TypeError, match="device"):
        layers.init_kv_cache(cfg, 2, 16)
    cache = layers.init_kv_cache(cfg, 2, 16, device="cpu")
    assert cache["k"].device.type == "cpu"
    scfg = registry.config("mamba2-2.7b").reduced()
    with pytest.raises(TypeError, match="device"):
        mamba2.init_ssm_cache(scfg, 2, 16, "fp32")
    state = mamba2.init_ssm_cache(scfg, 2, 16, "fp32", "cpu")
    assert all(t.device.type == "cpu" for t in state.values())


def test_launch_counters_stay_zero_on_cpu():
    ops.reset_launch_counts()
    bundle = registry.build("llama3.2-3b", reduced=True, device="cpu")
    model = bundle.model
    params = model.init(0)
    cache = model.init_cache(2, 48)
    prompt = torch.from_numpy(np.arange(9) % bundle.cfg.vocab)[None]
    view = {k: v[:, :1] for k, v in cache.items()}
    model.prefill(params, prompt, view)
    model.prefill_chunk(params, prompt, cache, 1, 0, 8)
    model.decode_step(params, torch.tensor([1, 2]), cache,
                      torch.tensor([9, 9]))
    assert ops.launch_counts() == {"flash_attention": 0, "flash_decode": 0,
                                   "flash_prefill_chunk": 0, "ssd": 0,
                                   "matmul": 0, "dotp": 0, "conv2d": 0,
                                   "flash_decode_scaled": 0,
                                   "flash_prefill_chunk_scaled": 0,
                                   "flash_decode_donor": 0,
                                   "flash_prefill_chunk_donor": 0,
                                   "flash_prefill_chunk_verify": 0}


def test_launch_counters_stay_zero_on_cpu_ssm():
    """A CPU ssm prefill, prefill chunk and decode step take the plain
    scan: no launch is counted."""
    ops.reset_launch_counts()
    bundle = registry.build("mamba2-2.7b", reduced=True, device="cpu")
    model = bundle.model
    params = model.init(0)
    cache = model.init_cache(2, 48)
    prompt = torch.from_numpy(np.arange(9) % bundle.cfg.vocab)[None]
    model.prefill(params, prompt, model.slot_view(cache, 0))
    model.prefill_chunk(params, prompt, cache, 1, 0, 8)
    model.decode_step(params, torch.tensor([1, 2]), cache,
                      torch.tensor([9, 9]))
    assert ops.launch_counts() == {"flash_attention": 0, "flash_decode": 0,
                                   "flash_prefill_chunk": 0, "ssd": 0,
                                   "matmul": 0, "dotp": 0, "conv2d": 0,
                                   "flash_decode_scaled": 0,
                                   "flash_prefill_chunk_scaled": 0,
                                   "flash_decode_donor": 0,
                                   "flash_prefill_chunk_donor": 0,
                                   "flash_prefill_chunk_verify": 0}


def test_launch_counters_stay_zero_on_cpu_vector_unit():
    """The vector-unit path on CPU tensors (the three ops and the
    chained multiply-reduce) takes the plain versions: no launch."""
    from repro_torch.core import chaining
    ops.reset_launch_counts()
    a, b = torch.ones(20, 12), torch.ones(12, 7)
    assert ops.matmul(a, b).shape == (20, 7)
    assert float(ops.dotp(a[0], a[1])) == 12.0
    assert float(chaining.chained_mulreduce(a[0], a[1])) == 12.0
    assert ops.conv2d(torch.ones(1, 9, 9, 3),
                      torch.ones(7, 7, 3, 8)).shape == (1, 3, 3, 8)
    assert ops.launch_counts() == {"flash_attention": 0, "flash_decode": 0,
                                   "flash_prefill_chunk": 0, "ssd": 0,
                                   "matmul": 0, "dotp": 0, "conv2d": 0,
                                   "flash_decode_scaled": 0,
                                   "flash_prefill_chunk_scaled": 0,
                                   "flash_decode_donor": 0,
                                   "flash_prefill_chunk_donor": 0,
                                   "flash_prefill_chunk_verify": 0}


def test_launch_counters_stay_zero_on_cpu_speculative():
    """A CPU speculative engine (draft micro-steps, verify chunks, the
    draft's prefill mirror, both prefill modes) takes the plain versions:
    no launch; its draft is built on the CPU with the target's kernels."""
    from repro_torch.runtime import serving
    bundle = registry.build("llama3.2-3b", reduced=True, device="cpu")
    params = bundle.model.init(0)
    ops.reset_launch_counts()
    for chunks in (None, (4, 8)):
        eng = serving.ServingEngine(
            bundle.model, bundle.cfg, params,
            config=serving.EngineConfig(
                max_slots=2, max_seq=48, prefill_chunks=chunks,
                speculative=serving.SpecConfig(draft="llama3.2-3b", k=2)))
        assert eng.draft_model.device.type == "cpu"
        assert eng.draft_model.kops is bundle.model.kops
        eng.submit(serving.Request(uid=0, prompt=np.arange(9) % 256,
                                   max_new_tokens=5))
        assert eng.run()[0].shape == (5,)
        assert eng.stats["spec_rounds"] > 0
    assert not any(ops.launch_counts().values()), ops.launch_counts()


def test_launch_counters_stay_zero_on_cpu_faults_and_router():
    """A CPU engine under a fault plan and the health ladder (poisoned and
    scrubbed slots, quarantine, dropped chunks and steps), and a CPU
    router over two replicas with a drain and migration, take the plain
    versions: no launch; every replica serves the one model object."""
    from repro_torch.runtime import serving
    bundle = registry.build("llama3.2-3b", reduced=True, device="cpu")
    params = bundle.model.init(0)
    ops.reset_launch_counts()
    config = serving.EngineConfig(
        max_slots=2, max_seq=48, prefill_chunks=(4, 8),
        faults=serving.FaultPlan.of(seed=1, alloc=0.1, chunk=0.2,
                                    decode=0.1, logits=0.2),
        health=serving.HealthConfig())
    eng = serving.ServingEngine(bundle.model, bundle.cfg, params,
                                config=config)
    for i in range(3):
        eng.submit(serving.Request(uid=i, prompt=np.arange(9 + i) % 256,
                                   max_new_tokens=5))
    eng.run(max_steps=2000)
    assert eng.stats["poisoned"] > 0 and eng.stats["quarantined"] > 0
    assert sum(n > 0 for n in eng.stats["faults"].values()) >= 2
    fleet = serving.Router(bundle.model, bundle.cfg, params,
                           config=serving.RouterConfig(
                               replicas=2, engine=config.replace(
                                   faults=None, health=None)))
    for i in range(4):
        fleet.submit(serving.Request(uid=i, prompt=np.arange(9 + i) % 256,
                                     max_new_tokens=5))
    fleet.step()
    fleet.drain(0, migrate=True)
    assert len(fleet.run(max_steps=2000)) == 4
    assert all(rep.engine.model is bundle.model
               for rep in fleet.replicas.values())
    assert not any(ops.launch_counts().values()), ops.launch_counts()
