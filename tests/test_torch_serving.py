"""The port's serving Engine (paddle_tpu_torch.serving) held against the JAX
Engine on the CPU, plus the port's package rules.

Token identity under the near-tie rule: a greedy stream must equal the
JAX stream token for token, except that a step where the JAX model's
top-2 logit margin is below ``TIE`` may flip (a reduction order can
decide a near-tie argmax); the rest of that request is then exempt,
since the two contexts differ from there on.  The test reports and
bounds how many requests were exempted.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu import serving as jserving
from paddle_tpu.models.llama import llama as jax_llama
from paddle_tpu_torch import serving as tserving
from paddle_tpu_torch.models import llama as torch_llama
from paddle_tpu_torch.models import params_from_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIE = 1e-3        # f32 logits of the two packages differ by ~1e-5
GEOM = dict(max_batch=4, max_seq_len=64, page_size=8, prefill_chunk=8)


@pytest.fixture(scope="module")
def models():
    pt.seed(0)
    jm = jax_llama("tiny", fused_ops="on")
    tm = params_from_numpy(
        torch_llama("tiny", device="cpu", fused_ops="on"),
        {k: np.asarray(v) for k, v in jm.named_parameters()})
    return jm, tm


def _drive(eng):
    """Staggered mixed-length greedy requests joining a running batch,
    then a shared page-aligned prefix served after its first request
    finished (prefix hits), one prompt fully cached (copy-on-write)."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, size=n) for n in (5, 19, 33, 12)]
    shared = rng.integers(0, 256, size=16)          # two full pages
    eng.add_request(prompts[0], max_new_tokens=8, request_id="a")
    eng.add_request(prompts[1], max_new_tokens=6, request_id="b")
    eng.step()
    eng.step()
    eng.add_request(prompts[2], max_new_tokens=7, request_id="c")
    eng.add_request(prompts[3], max_new_tokens=5, request_id="d")
    eng.add_request(np.concatenate([shared, [1, 2, 3]]), max_new_tokens=6,
                    request_id="p0")
    out = eng.run()
    eng.add_request(np.concatenate([shared, [4, 5]]), max_new_tokens=6,
                    request_id="p1")
    eng.add_request(shared.copy(), max_new_tokens=6, request_id="p2")
    out.update(eng.run())
    prompts = {"a": prompts[0], "b": prompts[1], "c": prompts[2],
               "d": prompts[3], "p0": np.concatenate([shared, [1, 2, 3]]),
               "p1": np.concatenate([shared, [4, 5]]), "p2": shared}
    return out, prompts


def _jax_margins(jm, prompt, out):
    """Top-2 logit margin of the JAX model at each generated position."""
    ids = np.concatenate([prompt, out[:-1]]).astype(np.int32)[None]
    lg = np.asarray(jm(jnp.asarray(ids)))[0, len(prompt) - 1:]
    top = np.sort(lg, axis=-1)[:, -2:]
    return top[:, 1] - top[:, 0]


def _near_tie_equal(ref, got, margins):
    """True if identical, "exempt" if they first differ at a near tie.
    ``margins`` is the reference's margin per token, or a function that
    computes it, called only at the first difference (a JAX forward per
    prompt length costs a compile)."""
    for i, (r, g) in enumerate(zip(ref, got)):
        if r != g:
            if callable(margins):
                margins = margins()
            assert margins[i] < TIE, (
                f"token {i}: {g} != {r} with margin {margins[i]}")
            return "exempt"
    assert len(ref) == len(got)
    return True


def test_engine_matches_jax_engine(models):
    jm, tm = models
    jeng = jserving.Engine(jm, **GEOM)
    jeng.warmup()
    jout, prompts = _drive(jeng)
    teng = tserving.Engine(tm, device="cpu", **GEOM)
    teng.warmup()
    tout, _ = _drive(teng)
    assert sorted(tout) == sorted(jout) == sorted(prompts)
    verdicts = {rid: _near_tie_equal(
        jout[rid], tout[rid],
        lambda rid=rid: _jax_margins(jm, prompts[rid], jout[rid]))
        for rid in jout}
    exempt = [r for r, v in verdicts.items() if v == "exempt"]
    assert len(exempt) <= 1, f"exempted requests: {exempt}"
    js, ts = jeng.prefix_stats(), teng.prefix_stats()
    for key in ("hits", "misses", "registered_pages", "cow_copies"):
        assert ts[key] == js[key], key
    assert ts["hits"] > 0 and ts["cow_copies"] > 0
    assert teng.kv_blocks_used == 0 and jeng.kv_blocks_used == 0


def test_warmup_and_idle_slots_leave_pools_unchanged(models):
    _, tm = models
    eng = tserving.Engine(tm, device="cpu", **GEOM)
    g = torch.Generator().manual_seed(0)
    for kc, vc in eng.kv.caches:
        kc.normal_(generator=g)
        vc.normal_(generator=g)
    before = [(k.clone(), v.clone()) for k, v in eng.kv.caches]
    eng.warmup()
    for (k0, v0), (k1, v1) in zip(before, eng.kv.caches):
        assert torch.equal(k0, k1) and torch.equal(v0, v1)
    # one live slot among idle ones: only its own blocks change
    eng.add_request(np.arange(11), max_new_tokens=3, request_id="x")
    eng.step()
    blocks = eng._states["x"].blocks
    others = [i for i in range(eng.kv.num_blocks) if i not in blocks]
    for (k0, v0), (k1, v1) in zip(before, eng.kv.caches):
        assert torch.equal(k0[others], k1[others])
        assert torch.equal(v0[others], v1[others])
        assert not torch.equal(k0[blocks], k1[blocks])
    eng.run()
    assert eng.kv_blocks_used == 0


def test_entry_points_raise_without_a_card(models, monkeypatch):
    _, tm = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserving.Engine(tm, **GEOM)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_llama("tiny")


def test_package_imports_neither_jax_nor_paddle_tpu():
    # the copies of the reference's JAX-free modules are named: a walk
    # that missed a package would leave them out silently
    copies = ["paddle_tpu_torch.resilience._state",
              "paddle_tpu_torch.resilience.faults",
              "paddle_tpu_torch.resilience.retry",
              "paddle_tpu_torch.observability._state",
              "paddle_tpu_torch.serving.spec"]
    code = (
        "import pkgutil, sys, importlib\n"
        "import paddle_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'paddle_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"missing = [m for m in {copies!r} if m not in sys.modules]\n"
        "bad = [m for m in sys.modules if m in ('jax', 'paddle_tpu')\n"
        "       or m.startswith(('jax.', 'paddle_tpu.'))]\n"
        "print('MISSING', missing)\n"
        "print('BAD', bad)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "MISSING []" in res.stdout, res.stdout
    assert "BAD []" in res.stdout, res.stdout


def test_chip_smoke_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
