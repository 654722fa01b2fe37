"""The port's robustness layer against the reference's, on the CPU.

Case by case the reference's chaos suite (``tests/test_faults.py``) on
``repro_torch.faults``, ``repro_torch.health``'s breakers, the ``ops``
degradation ladder and the runtime catch layers of serve and train. Where
the reference's behaviour is the spec, the same injection goes through
both packages on the same inputs. The reference's rungs are ``pallas``,
``jax`` and ``ref``; the port's ``cuda``, ``plain`` and ``ref`` (``RUNG``
maps them). Under this container's jax the reference's halo-indexed
Pallas rungs fail at trace and demote with ``pallas_error`` before any
injected fault, so such sites are compared on their outputs and on the
events of the injected kinds alone.

A CPU tensor has no ``cuda`` rung: its ladder starts at the kernel
wrapper's plain version. The tests of the ``cuda`` rung open it to CPU
tensors (``ops._on_card``), where the kernel wrappers run their plain
versions; the no-fallback tests hold that any error of a rung other than
an injected fault propagates with no event and no next rung, and that a
trip of the non-finite sentinel fails its request or step and demotes
nothing.
"""
import argparse
import contextlib
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import faults as jfaults  # noqa: E402
from repro import health as jhealth  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch import faults, health, obs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.health import HEALTH  # noqa: E402
from repro_torch.kernels import attention_decode as attn_dec  # noqa: E402
from repro_torch.kernels import autotune, gemm_plan  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import sliding_conv1d, sliding_conv2d  # noqa: E402
from repro_torch.kernels import sliding_conv_quant, sliding_pool  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CI = ROOT / ".github" / "workflows" / "ci.yml"
RUNG = {"pallas": "cuda", "jax": "plain", "ref": "ref"}
B, P, GEN = 2, 16, 8  # CI's chaos request
# the reference's eight ladder sites
SITES = ("attention_decode", "conv1d", "conv1d.w8a8", "conv1d_depthwise",
         "conv1d_depthwise.w8a8", "conv2d", "conv2d.w8a8", "pool1d")
CACHE_LEN = 2 * (P + GEN)


@pytest.fixture(autouse=True)
def _clean_slate():
    """No armed injection, no pending trip, an empty health record (events
    and breakers) and obs registry in both packages, before and after."""
    def reset():
        for f in (faults, jfaults):
            f.reset()
        for h in (health, jhealth):
            h.HEALTH.reset()
        obs.enable(False)
        obs.REGISTRY.reset()
        obs_trace.clear()
        for lg in (tops.ATTN_DECODE_DISPATCH, tops.CONV1D_DW_DISPATCH,
                   tops.CONV2D_DISPATCH, tops.CONV2D_QUANT_DISPATCH,
                   tops.POOL1D_DISPATCH):
            lg.clear()
    reset()
    yield
    reset()


@pytest.fixture
def on_card(monkeypatch):
    """Open the ``cuda`` rung to CPU tensors: the ladder starts at the
    kernel wrapper (its plain version here), then ``plain``, then ``ref``."""
    monkeypatch.setattr(tops, "_on_card", lambda t: True)


@pytest.fixture
def lower_calls(monkeypatch):
    """The ladder's lower rungs, watched: each call of ``lower()`` and of a
    lower rung's thunk is appended as ("built", site) / (rung, site)."""
    calls = []
    real = tops._ladder

    def ladder(site, kernel, lower, **kw):
        def watched():
            calls.append(("built", site))
            return [(n, lambda _t=t, _n=n: calls.append((_n, site)) or _t())
                    for n, t in lower()]
        return real(site, kernel, watched, **kw)

    monkeypatch.setattr(tops, "_ladder", ladder)
    return calls


def _events(h, site=None, kinds=None):
    """(site, reason, action) of a health record, rungs in the port's
    names, optionally only the given reasons."""
    out = []
    for e in h.HEALTH.events_for(site):
        if kinds is not None and e.reason not in kinds:
            continue
        action = e.action
        for a, b in RUNG.items():
            action = action.replace(f":{a}", f":{b}").replace(f">{a}", f">{b}")
        out.append((e.site, e.reason, action))
    return out


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, tol=2e-5):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float32),
                               np.asarray(want, dtype=np.float32),
                               rtol=tol, atol=tol)


# -- injector -----------------------------------------------------------------

SPECS = ["pallas_compile:conv1d*2, slow_step ,jax_runtime:a.b",
         "pallas_runtime:conv1d*1,nan_activations:serve/slot.1*1",
         "quant_scale_zero:whisper/conv1", "", " , ", "heartbeat_stale:host_1*3"]


@pytest.mark.parametrize("spec", SPECS)
def test_env_spec_parsing(spec):
    got = [(i.kind, i.site, i.times) for i in faults._parse_env(spec)]
    assert got == [(i.kind, i.site, i.times) for i in jfaults._parse_env(spec)]


def test_env_spec_parsing_values():
    injs = faults._parse_env(SPECS[0])
    assert [(i.kind, i.site, i.times) for i in injs] == [
        ("pallas_compile", "conv1d", 2), ("slow_step", None, None),
        ("jax_runtime", "a.b", None)]


def test_env_arming_and_reset(monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "pallas_compile:conv1d")
    faults.reload_env()
    assert faults.ARMED
    assert faults.active("pallas_compile", "conv1d.w8a8") is not None
    assert faults.active("pallas_compile", "conv2d") is None
    faults.reset()  # disarms the environment's injections too
    assert not faults.ARMED
    assert faults.active("pallas_compile", "conv1d") is None
    assert faults.ENV_VAR == jfaults.ENV_VAR
    assert faults.SENTINEL_ENV == jfaults.SENTINEL_ENV


def test_times_budget():
    with faults.inject("jax_runtime", times=2):
        assert faults.take("jax_runtime")
        assert faults.take("jax_runtime")
        assert not faults.take("jax_runtime")
    assert not faults.take("jax_runtime")  # leaving the block disarms
    assert not faults.ARMED


@pytest.mark.parametrize("armed, site", [
    ("conv1d", "conv1d"), ("conv1d", "conv1d.w8a8"), ("conv1d", "conv1dx"),
    ("conv1d", "conv2d"), ("conv1d", None), (None, "anything"),
    ("serve/slot.1", "serve/slot.1"), ("serve/slot.1", "serve/slot.10"),
    ("serve/slot", "serve/slot.0")])
def test_site_prefix_matching(armed, site):
    with faults.inject("pallas_compile", site=armed), \
            jfaults.inject("pallas_compile", site=armed):
        got = faults.active("pallas_compile", site) is not None
        assert got == (jfaults.active("pallas_compile", site) is not None)


@pytest.mark.parametrize("p, seed", [(0.5, 7), (0.2, 0), (0.9, 3)])
def test_probabilistic_firing_is_deterministic(p, seed):
    """A seeded ``p`` fires as a function of the call order alone, the
    reference's sequence draw for draw."""
    def sequence(f):
        with f.inject("slow_step", p=p, seed=seed) as inj:
            return [inj.take() for _ in range(32)]

    a = sequence(faults)
    assert a == sequence(faults) == sequence(jfaults)
    assert any(a) and not all(a)


def test_maybe_fail_carries_reason_code():
    with faults.inject("pallas_runtime", site="conv2d"):
        with pytest.raises(faults.FaultError) as ei:
            faults.maybe_fail("pallas_runtime", "conv2d.w8a8")
    assert (ei.value.kind, ei.value.site) == ("pallas_runtime", "conv2d.w8a8")
    assert health.canon_reason(ei.value) == "pallas_runtime"


def test_sleep_point_sleeps_when_armed():
    assert faults.sleep_point("slow_step", "train") == 0.0
    with faults.inject("slow_step", delay_s=0.01):
        t0 = time.time()
        assert faults.sleep_point("slow_step", "train") == 0.01
        assert time.time() - t0 >= 0.009


def test_rung_kind_tables():
    """The reference's kinds on the port's rung names."""
    assert faults.RUNG_KINDS == {RUNG[r]: k for r, k in jfaults.RUNG_KINDS.items()}
    assert faults.RUNTIME_RUNG_KINDS == {
        RUNG[r]: k for r, k in jfaults.RUNTIME_RUNG_KINDS.items()}


def test_disarmed_hooks_do_nothing():
    x = torch.ones(2, 3)
    assert not faults.ARMED
    assert faults.corrupt_array("nan_activations", None, x) is x
    assert faults.corrupt_rows("nan_activations", "serve/slot", x) is x
    assert faults.guest_trap("conv1d", "cuda", "k", x) is None
    faults.raise_pending("cpu")
    assert faults.consume_trip() is None
    t0 = time.perf_counter()
    for _ in range(200_000):
        faults.guest_trap("conv1d", "cuda", "k", x)
    assert time.perf_counter() - t0 < 2.0


def test_corrupt_hooks_match_the_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 4)).astype(np.float32)
    with faults.inject("nan_activations", site="serve/slot.1", times=1), \
            jfaults.inject("nan_activations", site="serve/slot.1", times=1):
        got = faults.corrupt_rows("nan_activations", "serve/slot", _t(x))
        want = jfaults.corrupt_rows("nan_activations", "serve/slot",
                                    jnp.asarray(x))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.isnan(got[1]).all() and torch.isfinite(got[[0, 2]]).all()
    with faults.inject("nan_activations", site="serve/logits"):
        assert torch.isnan(faults.corrupt_array(
            "nan_activations", "serve/logits", _t(x))).all()
    s = torch.tensor(0.5)
    with faults.inject("quant_scale_zero", site="w/conv1"):
        assert float(faults.corrupt_scale("w/conv1", s)) == 0.0
        assert faults.corrupt_scale("w/conv2", s) is s
    with faults.inject("quant_scale_nan"):
        assert torch.isnan(faults.corrupt_scale("w/conv1", s))


# -- the ops ladder: on a CPU tensor (plain -> ref) ------------------------------

def _conv1d_operands(rng):
    return (rng.normal(size=(1, 32, 4)).astype(np.float32),
            rng.normal(size=(3, 4, 4)).astype(np.float32))


def test_conv1d_ladder_demotes_and_matches(rng):
    """``jax_runtime`` at conv1d fails the top rung of both ladders (the
    reference's ``jax``, the port's CPU ``plain``): the ``ref`` rung
    serves, the demotion sticks, and the outputs agree."""
    x, w = _conv1d_operands(rng)
    clean = tops.conv1d(_t(x), _t(w))
    with faults.inject("jax_runtime", site="conv1d"), \
            jfaults.inject("jax_runtime", site="conv1d"):
        out = tops.conv1d(_t(x), _t(w))
        jout = jops.conv1d(jnp.asarray(x), jnp.asarray(w))
    _close(out, clean)
    _close(out, jout)
    assert HEALTH.is_demoted("conv1d", "plain")
    assert (_events(health, "conv1d", {"jax_runtime"})
            == _events(jhealth, "conv1d", {"jax_runtime"})
            == [("conv1d", "jax_runtime", "demote:plain->ref")])
    again = tops.conv1d(_t(x), _t(w))  # sticky: ref again, bit for bit
    torch.testing.assert_close(again, out, rtol=0, atol=0)


def test_cpu_tensor_clean_call_stays_on_its_plain_version(rng, monkeypatch,
                                                          lower_calls):
    """Nothing armed: the CPU call is the kernel wrapper's plain version as
    before the ladder, and the lower rungs are never built."""
    x, w = _conv1d_operands(rng)
    calls = []
    real = sliding_conv1d.conv1d_sliding
    monkeypatch.setattr(sliding_conv1d, "conv1d_sliding",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tops.conv1d(_t(x), _t(w))
    assert calls == [1] and HEALTH.events == [] and lower_calls == []


# -- the ops ladder: the cuda rung -----------------------------------------------

def test_conv1d_compile_fault_demotes_cuda_to_plain(rng, on_card, monkeypatch):
    """``pallas_compile`` fails the kernel before its launch; the plain
    twin serves, as the reference's compiled-JAX rung does, with the
    reference's event."""
    x, w = _conv1d_operands(rng)
    launched = []
    real = sliding_conv1d.conv1d_sliding
    monkeypatch.setattr(sliding_conv1d, "conv1d_sliding",
                        lambda *a, **k: launched.append(1) or real(*a, **k))
    clean = tops.conv1d(_t(x), _t(w))
    assert launched == [1]
    with faults.inject("pallas_compile", site="conv1d"), \
            jfaults.inject("pallas_compile", site="conv1d"):
        out = tops.conv1d(_t(x), _t(w))
        jout = jops.conv1d(jnp.asarray(x), jnp.asarray(w))
    assert launched == [1]  # the kernel never ran
    _close(out, clean)
    _close(out, jout)
    assert (_events(health) == _events(jhealth)
            == [("conv1d", "pallas_compile", "demote:cuda->plain")])
    assert HEALTH.is_demoted("conv1d", "cuda")


def test_conv1d_double_fault_chains_to_ref(rng, on_card):
    x, w = _conv1d_operands(rng)
    clean = tops.conv1d(_t(x), _t(w))
    with faults.inject("pallas_compile", site="conv1d"), \
            faults.inject("jax_runtime", site="conv1d"), \
            jfaults.inject("pallas_compile", site="conv1d"), \
            jfaults.inject("jax_runtime", site="conv1d"):
        out = tops.conv1d(_t(x), _t(w))
        jout = jops.conv1d(jnp.asarray(x), jnp.asarray(w))
    _close(out, clean)
    _close(out, jout)
    assert HEALTH.demotions() == {"conv1d": frozenset({"cuda", "plain"})}
    assert _events(health) == _events(jhealth) == [
        ("conv1d", "pallas_compile", "demote:cuda->plain"),
        ("conv1d", "jax_runtime", "demote:plain->ref")]


def test_conv2d_ladder(rng, on_card):
    x = rng.normal(size=(1, 10, 10, 3)).astype(np.float32)
    w = rng.normal(size=(3, 3, 3, 4)).astype(np.float32)
    clean = tops.conv2d(_t(x), _t(w))
    key = next(iter(dict(tops.CONV2D_DISPATCH.items())))
    assert tops.CONV2D_DISPATCH[key] == "cuda"
    with faults.inject("pallas_compile", site="conv2d"), \
            jfaults.inject("pallas_compile", site="conv2d"):
        out = tops.conv2d(_t(x), _t(w))
        jout = jops.conv2d(jnp.asarray(x), jnp.asarray(w))
    _close(out, clean)
    _close(out, jout)
    assert HEALTH.is_demoted("conv2d", "cuda")
    assert _events(health) == _events(jhealth)
    assert tops.CONV2D_DISPATCH[key] == "plain"  # the rung that served


def test_depthwise_runtime_fault_surfaces_at_raise_pending(rng, on_card):
    """``pallas_runtime`` lets the kernel run and records its trip: the
    failure surfaces at the caller's next synchronise
    (``raise_pending``), the catch layer demotes the rung, and the next
    call runs on ``plain``. (The reference's eager trap demotes inside the
    ladder; its compiled path surfaces at the call, as here.)"""
    x = rng.normal(size=(1, 32, 4)).astype(np.float32)
    w = rng.normal(size=(3, 4)).astype(np.float32)
    clean = tops.conv1d_depthwise(_t(x), _t(w))
    with faults.inject("pallas_runtime", site="conv1d_depthwise"):
        out = tops.conv1d_depthwise(_t(x), _t(w))
        torch.testing.assert_close(out, clean, rtol=0, atol=0)  # cuda ran
        assert HEALTH.events == []
        with pytest.raises(faults.FaultError) as ei:
            faults.raise_pending("cpu")
        assert ei.value.kind == "pallas_runtime"
        trip = faults.consume_trip()
        key = autotune.conv1d_dw_key(1, 34, 4, 3, 1, "float32")
        assert trip == faults.Trip("conv1d_depthwise", "cuda", key,
                                   "pallas_runtime")
        faults.raise_pending("cpu")  # consumed: nothing pending
        health.demote_tripped(trip, ei.value)
        again = tops.conv1d_depthwise(_t(x), _t(w))
    _close(again, clean)
    assert _events(health) == [("conv1d_depthwise", "pallas_runtime",
                                "demote:cuda(runtime)")]
    assert tops.CONV1D_DW_DISPATCH[key] == "plain"
    assert obs.REGISTRY.counter("runtime.demote").value(
        site="conv1d_depthwise", rung="cuda", key=key) == 1.0


def test_sentinel_trip_on_the_cuda_rung_demotes_nothing(rng, on_card,
                                                        monkeypatch):
    """A kernel's own non-finite output on the ``cuda`` rung (a NaN input,
    nothing injected) trips the sentinel at ``raise_pending``; the catch
    layer's ``demote_tripped`` records ``error:cuda(sentinel)``, opens no
    breaker and answers False, and the next call is the kernel's again."""
    monkeypatch.setenv(faults.SENTINEL_ENV, "1")
    faults.reload_env()
    x = rng.normal(size=(1, 32, 4)).astype(np.float32)
    w = rng.normal(size=(3, 4)).astype(np.float32)
    bad = x.copy()
    bad[0, 5, 1] = np.nan
    tops.conv1d_depthwise(_t(bad), _t(w))
    with pytest.raises(faults.FaultError) as ei:
        faults.raise_pending("cpu")
    trip = faults.consume_trip()
    key = autotune.conv1d_dw_key(1, 34, 4, 3, 1, "float32")
    assert trip == faults.Trip("conv1d_depthwise", "cuda", key,
                               "nan_activations", injected=False)
    assert health.demote_tripped(trip, ei.value) is False
    assert _events(health) == [("conv1d_depthwise", "nan_activations",
                                "error:cuda(sentinel)")]
    assert not HEALTH.has_breakers
    assert obs.REGISTRY.counter("runtime.demote").series() == []
    tops.conv1d_depthwise(_t(x), _t(w))
    faults.raise_pending("cpu")  # finite: nothing pending
    assert tops.CONV1D_DW_DISPATCH[key] == "cuda"
    monkeypatch.delenv(faults.SENTINEL_ENV)
    faults.reset()


def test_pool1d_ladder_and_last_rung_propagates(rng, on_card):
    x = rng.normal(size=(1, 32, 4)).astype(np.float32)
    clean = tops.pool1d(_t(x), window=4, op="max")
    with faults.inject("pallas_compile", site="pool1d"), \
            jfaults.inject("pallas_compile", site="pool1d"):
        out = tops.pool1d(_t(x), window=4, op="max")
        jout = jops.pool1d(jnp.asarray(x), window=4, op="max")
    _close(out, clean)
    _close(out, jout)
    assert _events(health) == _events(jhealth)
    # both rungs failing: nothing left to degrade to, the fault surfaces
    HEALTH.reset()
    jhealth.HEALTH.reset()
    with faults.inject("pallas_compile", site="pool1d"), \
            faults.inject("jax_runtime", site="pool1d"), \
            jfaults.inject("pallas_compile", site="pool1d"), \
            jfaults.inject("jax_runtime", site="pool1d"):
        with pytest.raises(faults.FaultError):
            tops.pool1d(_t(x), window=4, op="sum")
        with pytest.raises(jfaults.FaultError):
            jops.pool1d(jnp.asarray(x), window=4, op="sum")
    assert _events(health) == _events(jhealth)


def test_cpu_pool1d_has_one_rung(rng):
    """On a CPU tensor the pool's one rung is its plain version: a fault
    there surfaces (the reference's last rung)."""
    x = rng.normal(size=(1, 16, 4)).astype(np.float32)
    with faults.inject("jax_runtime", site="pool1d"):
        with pytest.raises(faults.FaultError):
            tops.pool1d(_t(x), window=4, op="sum")
    assert HEALTH.events == []


def test_fully_demoted_site_still_serves(rng, on_card):
    x = rng.normal(size=(1, 16, 4)).astype(np.float32)
    for h, rungs in ((HEALTH, ("cuda", "plain")),
                     (jhealth.HEALTH, ("pallas", "jax"))):
        for r in rungs:
            h.demote("pool1d", r)
    out = tops.pool1d(_t(x), window=4, op="sum")  # the last rung serves
    jout = jops.pool1d(jnp.asarray(x), window=4, op="sum")
    assert out.shape == (1, 13, 4) and bool(torch.isfinite(out).all())
    _close(out, jout)


def _attn(rng):
    Bq, S, KV, G, D = 2, 16, 2, 2, 8
    return (rng.normal(size=(Bq, KV * G, D)).astype(np.float32),
            rng.normal(size=(Bq, S, KV, D)).astype(np.float32),
            rng.normal(size=(Bq, S, KV, D)).astype(np.float32),
            np.asarray([5, S], np.int32))


def test_attention_decode_ladder(rng, on_card):
    q, k, v, lengths = _attn(rng)
    jref = jops.attention_decode(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), lengths=jnp.asarray(lengths),
                                 impl="ref")
    with faults.inject("pallas_compile", site="attention_decode"), \
            jfaults.inject("pallas_compile", site="attention_decode"):
        out = tops.attention_decode(_t(q), _t(k), _t(v), lengths=_t(lengths))
        jout = jops.attention_decode(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            lengths=jnp.asarray(lengths), impl="pallas")
    np.testing.assert_allclose(out.numpy(), np.asarray(jref), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-4,
                               atol=1e-5)
    assert HEALTH.is_demoted("attention_decode", "cuda")
    assert _events(health) == _events(jhealth)
    (key, impl), = tops.ATTN_DECODE_DISPATCH.items()
    assert impl == "plain" and key == autotune.attn_dec_key(2, 16, 2, 2, 8,
                                                             "float32")


def test_attention_decode_double_fault_serves_ref(rng, on_card):
    q, k, v, lengths = _attn(rng)
    with faults.inject("pallas_compile"), faults.inject("jax_runtime"):
        out = tops.attention_decode(_t(q), _t(k), _t(v), lengths=_t(lengths))
    want = attn_dec.attention_decode_ref(_t(q).reshape(2, 2, 2, 8), _t(k),
                                         _t(v), _t(lengths))
    torch.testing.assert_close(out, want.reshape(2, 4, 8), rtol=0, atol=0)
    assert tops.ATTN_DECODE_DISPATCH.items()[0][1] == "ref"


@pytest.mark.parametrize("precision", ["w8a8", "w8a16"])
def test_quant_conv1d_ladder(rng, on_card, precision):
    x, w = _conv1d_operands(rng)
    clean = tops.conv1d(_t(x), _t(w), precision=precision)
    with faults.inject("pallas_compile", site="conv1d"), \
            jfaults.inject("pallas_compile", site="conv1d"):
        out = tops.conv1d(_t(x), _t(w), precision=precision)
        jout = jops.conv1d(jnp.asarray(x), jnp.asarray(w),
                           precision=precision)
    _close(out, clean, 1e-5)
    _close(out, jout, 1e-5)
    assert HEALTH.is_demoted(f"conv1d.{precision}", "cuda")
    assert _events(health) == _events(jhealth) == [
        (f"conv1d.{precision}", "pallas_compile", "demote:cuda->plain")]


def test_quant_depthwise_and_conv2d_ladders(rng, on_card):
    x = rng.normal(size=(1, 32, 4)).astype(np.float32)
    w = rng.normal(size=(3, 4)).astype(np.float32)
    x2 = rng.normal(size=(1, 9, 10, 3)).astype(np.float32)
    w2 = rng.normal(size=(3, 3, 3, 5)).astype(np.float32)
    clean = (tops.conv1d_depthwise(_t(x), _t(w), precision="w8a8"),
             tops.conv2d(_t(x2), _t(w2), precision="w8a8"))
    with faults.inject("pallas_compile"):
        out = (tops.conv1d_depthwise(_t(x), _t(w), precision="w8a8"),
               tops.conv2d(_t(x2), _t(w2), precision="w8a8"))
    for a, b in zip(out, clean):
        _close(a, b, 1e-5)
    assert HEALTH.demotions() == {"conv1d_depthwise.w8a8": {"cuda"},
                                  "conv2d.w8a8": {"cuda"}}
    assert tops.CONV2D_QUANT_DISPATCH.items()[-1][1] == "plain"
    assert tops.CONV1D_DW_DISPATCH.items()[-1][1] == "plain"


@pytest.mark.parametrize("site", SITES)
def test_clean_card_call_reaches_only_its_kernel(rng, on_card, monkeypatch,
                                                 lower_calls, site):
    """Nothing armed, no breaker: the kernel serves, the lower rungs are
    never built, nothing is recorded."""
    (mod, name), call = _entries(rng)[site]
    hits = []
    real = getattr(mod, name)
    monkeypatch.setattr(mod, name, lambda *a, **k: hits.append(1)
                        or real(*a, **k))
    call()
    assert hits == [1] and lower_calls == []
    assert HEALTH.events == [] and faults.consume_trip() is None


# -- no fallback that hides the kernel ---------------------------------------------

def _entries(rng):
    """Each ladder site's call, and the wrapper its top rung runs."""
    x, w = _conv1d_operands(rng)
    xd = rng.normal(size=(1, 32, 4)).astype(np.float32)
    wd = rng.normal(size=(3, 4)).astype(np.float32)
    x2 = rng.normal(size=(1, 9, 10, 3)).astype(np.float32)
    w2 = rng.normal(size=(3, 3, 3, 5)).astype(np.float32)
    q, k, v, lengths = _attn(rng)
    return {
        "conv1d": ((sliding_conv1d, "conv1d_sliding"),
                   lambda: tops.conv1d(_t(x), _t(w))),
        "conv1d.w8a8": ((sliding_conv_quant, "conv1d_quant"),
                        lambda: tops.conv1d(_t(x), _t(w), precision="w8a8")),
        "conv1d_depthwise": ((sliding_conv1d, "conv1d_depthwise"),
                             lambda: tops.conv1d_depthwise(_t(xd), _t(wd))),
        "conv1d_depthwise.w8a8": (
            (sliding_conv_quant, "conv1d_depthwise_quant"),
            lambda: tops.conv1d_depthwise(_t(xd), _t(wd), precision="w8a8")),
        "conv2d": ((sliding_conv2d, "conv2d_sliding"),
                   lambda: tops.conv2d(_t(x2), _t(w2))),
        "conv2d.w8a8": ((sliding_conv_quant, "conv2d_quant"),
                        lambda: tops.conv2d(_t(x2), _t(w2), precision="w8a8")),
        "attention_decode": ((attn_dec, "decode_attention"),
                             lambda: tops.attention_decode(
                                 _t(q), _t(k), _t(v), lengths=_t(lengths))),
        "pool1d": ((sliding_pool, "sliding_pool"),
                   lambda: tops.pool1d(_t(xd), window=4)),
    }


ERRORS = {"runtime": RuntimeError("CUDA error: an illegal memory access"),
          "plan": gemm_plan.PlanError("refused"),
          "shape": ValueError("bad shape")}


@pytest.mark.parametrize("armed", [False, True], ids=["disarmed", "armed"])
@pytest.mark.parametrize("error", sorted(ERRORS))
@pytest.mark.parametrize("site", SITES)
def test_a_real_kernel_error_propagates_with_no_event(rng, on_card,
                                                      monkeypatch, lower_calls,
                                                      site, error, armed):
    """A kernel rung that raises anything but an injected fault: the error
    reaches the caller unchanged, no rung below runs, no event, no
    breaker; with a fault armed elsewhere (the ladder's slow path) too."""
    (mod, name), call = _entries(rng)[site]
    exc = ERRORS[error]

    def broken(*a, **k):
        raise exc

    monkeypatch.setattr(mod, name, broken)
    with faults.inject("slow_step", site="elsewhere") if armed else \
            contextlib.nullcontext():
        assert faults.ARMED == armed
        with pytest.raises(type(exc)) as ei:
            call()
    assert ei.value is exc
    # armed, the ladder builds its lower rungs, and runs none of them
    assert [c for c in lower_calls if c[0] != "built"] == []
    assert HEALTH.events == [] and HEALTH.demotions() == {}


def test_a_real_plain_error_propagates_on_the_cpu(rng, monkeypatch):
    x, w = _conv1d_operands(rng)
    exc = RuntimeError("broken plain version")
    monkeypatch.setattr(sliding_conv1d, "conv1d_sliding",
                        lambda *a, **k: (_ for _ in ()).throw(exc))
    with faults.inject("jax_runtime", site="conv2d"):  # armed, elsewhere
        with pytest.raises(RuntimeError) as ei:
            tops.conv1d(_t(x), _t(w))
    assert ei.value is exc and HEALTH.events == []


def test_dispatch_metrics_name_the_serving_rung(rng, on_card):
    x, w = _conv1d_operands(rng)
    obs.metrics.enable_dispatch()
    try:
        tops.conv1d(_t(x), _t(w))
        with faults.inject("pallas_compile", site="conv1d"):
            tops.conv1d(_t(x), _t(w))
    finally:
        obs.metrics.enable_dispatch(False)
    rungs = sorted(lb["rung"] for lb, _ in
                   obs.REGISTRY.counter("dispatch.calls").series())
    assert rungs == ["cuda", "plain"]


# -- quantization scale faults ---------------------------------------------------

def test_calibration_scale_fault_screened_at_quantize(rng):
    """A poisoned calibration scale never reaches dispatch: both packages'
    ``quantize_params`` screen it, leave the site float and record the
    same event."""
    from repro.quant.apply import quantize_params as jquantize_params
    from repro.quant.calibrate import Calibration as JCalibration
    from repro.quant.calibrate import collecting as jcollecting
    from repro.quant.calibrate import observe as jobserve
    from repro_torch.quant.apply import quantize_params
    from repro_torch.quant.calibrate import Calibration, collecting, observe
    from repro_torch.quant.qconv import QuantizedWeight

    a1 = rng.normal(size=(2, 16, 8)).astype(np.float32)
    a2 = rng.normal(size=(2, 16, 8)).astype(np.float32)
    calib, jcalib = Calibration(percentile=None), JCalibration(percentile=None)
    with collecting(calib):
        observe("whisper/conv1", _t(a1))
        observe("whisper/conv2", _t(a2))
    with jcollecting(jcalib):
        jobserve("whisper/conv1", a1)
        jobserve("whisper/conv2", a2)
    with faults.inject("quant_scale_nan", site="whisper/conv1"), \
            jfaults.inject("quant_scale_nan", site="whisper/conv1"):
        spec, jspec = calib.spec(), jcalib.spec()
    assert torch.isnan(spec["whisper/conv1"]["x_scale"])
    assert not np.isfinite(jspec["whisper/conv1"]["x_scale"])
    np.testing.assert_allclose(float(spec["whisper/conv2"]["x_scale"]),
                               float(jspec["whisper/conv2"]["x_scale"]),
                               rtol=1e-6)
    qp = quantize_params({"f": {"conv1_w": torch.ones(3, 8, 8),
                                "conv2_w": torch.ones(3, 8, 8)}}, spec)
    jquantize_params({"f": {"conv1_w": jnp.ones((3, 8, 8)),
                            "conv2_w": jnp.ones((3, 8, 8))}}, jspec)
    assert not isinstance(qp["f"]["conv1_w"], QuantizedWeight)
    assert isinstance(qp["f"]["conv2_w"], QuantizedWeight)
    assert _events(health) == _events(jhealth) == [
        ("whisper/conv1", "quant_scale_nan", "fallback:fp")]


@pytest.mark.parametrize("kind", ["quant_scale_zero", "quant_scale_nan"])
def test_zero_or_nan_x_scale_float_weight_falls_back_to_fp(rng, kind):
    x, w = _conv1d_operands(rng)
    bad = 0.0 if kind == "quant_scale_zero" else float("nan")
    out = tops.conv1d(_t(x), _t(w), precision="w8a8",
                      x_scale=torch.tensor(bad))
    jops.conv1d(jnp.asarray(x), jnp.asarray(w), precision="w8a8",
                x_scale=jnp.float32(bad))
    assert bool(torch.isfinite(out).all())
    _close(out, tops.conv1d(_t(x), _t(w)))
    assert _events(health, kinds={kind}) == _events(jhealth, kinds={kind}) == [
        ("conv1d.w8a8", kind, "fallback:fp")]


# -- tuning cache, checkpoints, heartbeats ---------------------------------------

def test_autotune_injected_corruption(tmp_path, monkeypatch):
    import json

    p = tmp_path / "autotune_cuda.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(p))
    p.write_text(json.dumps({"k": {"tile": "mma"}}))
    autotune.invalidate()
    try:
        with faults.inject("autotune_corrupt", times=1):
            assert autotune.lookup("k") is None  # a sound file, forced corrupt
        assert (tmp_path / "autotune_cuda.json.corrupt").exists()
        (ev,) = HEALTH.events_for("autotune", reason="cache_corrupt")
        assert ev.action == "quarantine"
        assert "autotune_corrupt" in ev.detail
    finally:
        autotune.invalidate()


def _state(rng):
    return {"w": _t(rng.normal(size=(8, 8)).astype(np.float32)),
            "b": torch.zeros(8)}


def test_ckpt_corrupt_fault_recovers_previous_step(tmp_path, rng):
    from repro_torch.checkpoint import CheckpointManager, latest_step

    mgr = CheckpointManager(tmp_path, keep=5)
    state = _state(rng)
    mgr.save(1, state)
    with faults.inject("ckpt_corrupt", site="step_5", times=1):
        mgr.save(5, state)  # one leaf truncated after its nbytes landed
    assert mgr.validate(1) is None
    assert mgr.validate(5) is not None
    assert mgr.latest_valid_step() == 1
    assert (tmp_path / "step_5.corrupt").exists()
    (ev,) = HEALTH.events_for("ckpt", reason="ckpt_invalid")
    assert ev.action == "quarantine"
    assert latest_step(tmp_path) == 1


def test_ckpt_corruption_reads_as_the_reference_reads_it(tmp_path, rng):
    """The port's torn step fails the reference's validation too."""
    from repro.checkpoint import CheckpointManager as JManager
    from repro_torch.checkpoint import CheckpointManager

    with faults.inject("ckpt_corrupt", site="step_2", times=1):
        CheckpointManager(tmp_path, keep=2).save(2, _state(rng))
    assert JManager(tmp_path, keep=2).validate(2) is not None


def test_ckpt_write_stall_injection(tmp_path, rng):
    from repro_torch.checkpoint import CheckpointManager

    mgr = CheckpointManager(tmp_path, keep=2)
    with faults.inject("ckpt_write_stall", delay_s=0.01):
        t0 = time.time()
        mgr.save(3, _state(rng))
    assert time.time() - t0 >= 0.02  # two leaves, 0.01 s each
    assert mgr.latest_valid_step() == 3


def test_heartbeat_stale_fault_suppresses_beat(tmp_path):
    from repro.distributed import ft as jft
    from repro_torch.distributed.ft import beat, heartbeat_file, stale_hosts

    with faults.inject("heartbeat_stale", site="host_1"):
        beat(tmp_path / "port", 0)
        beat(tmp_path / "port", 1)
    with jfaults.inject("heartbeat_stale", site="host_1"):
        jft.beat(tmp_path / "ref", 0)
        jft.beat(tmp_path / "ref", 1)
    assert heartbeat_file(tmp_path / "port", 0).exists()
    assert not heartbeat_file(tmp_path / "port", 1).exists()
    assert stale_hosts(tmp_path / "port", timeout_s=60) == []
    assert sorted(p.name for p in (tmp_path / "port" / "heartbeats").iterdir()) \
        == sorted(p.name for p in (tmp_path / "ref" / "heartbeats").iterdir())


# -- the runtime trap and the breakers ----------------------------------------

def test_runtime_sentinel_trips_on_nonfinite(monkeypatch):
    """With ``REPRO_RUNTIME_SENTINEL`` the trap flags a non-finite output on
    the device; ``raise_pending`` reads the flags once and raises with the
    reference's trip."""
    monkeypatch.setenv(faults.SENTINEL_ENV, "1")
    faults.reload_env()
    assert faults.ARMED and faults.sentinel_on()
    ok = torch.ones(2, 2)
    bad = ok.clone()
    bad[0, 0] = float("nan")
    faults.guest_trap("conv1d", "cuda", "k", ok)
    faults.raise_pending("cpu")  # finite: nothing to raise
    faults.guest_trap("conv1d", "cuda", "k", ok)
    faults.guest_trap("conv2d", "cuda", "k2", ok)
    faults.guest_trap("conv2d", "cuda", "k2", bad)
    with pytest.raises(faults.FaultError) as ei:
        faults.raise_pending("cpu")
    assert (ei.value.kind, ei.value.site) == ("nan_activations", "conv2d")
    assert faults.consume_trip() == faults.Trip(
        "conv2d", "cuda", "k2", "nan_activations", injected=False)
    assert faults.consume_trip() is None  # the mailbox is consume-once
    monkeypatch.delenv(faults.SENTINEL_ENV)
    faults.reset()
    assert not faults.ARMED


def test_trap_fires_armed_kinds_after_the_launch():
    with faults.inject("pallas_runtime", site="conv1d", times=1):
        faults.guest_trap("conv1d", "plain", "k", torch.ones(1))  # not its rung
        assert faults.consume_trip() is None
        faults.guest_trap("conv1d", "cuda", "k", torch.ones(1))
        faults.guest_trap("conv1d", "cuda", "k", torch.ones(1))  # spent
    assert faults.consume_trip() == faults.Trip("conv1d", "cuda", "k",
                                                "pallas_runtime")
    with faults.inject("nan_activations", site="conv1d", times=1):
        faults.guest_trap("conv1d", "plain", "k", torch.ones(1))
    assert faults.consume_trip().kind == "nan_activations"


def test_consume_trip_site_filter():
    faults._record_trip(faults.Trip("conv1d", "cuda", "k", "pallas_runtime"))
    assert faults.consume_trip("conv2d") is None  # not ours: left in place
    assert faults.consume_trip("conv1d") is not None
    assert faults.consume_trip() is None


def _breakers(h, since=False):
    """Each breaker's state; ``since`` adds its trip time (on a shared
    fake clock)."""
    return {k: (b.reason, b.trips, b.clean, b.state)
            + ((b.since,) if since else ())
            for k, b in sorted(h.HEALTH._breakers.items())}


def _record(h):
    return [(e.site, e.reason, e.action, e.detail, e.count)
            for e in h.HEALTH.events]


def test_breaker_probation_repromotes(monkeypatch):
    monkeypatch.setenv("REPRO_HEALTH_COOLDOWN_CALLS", "3")
    for h in (health, jhealth):
        H = h.HEALTH
        H.demote("conv1d", "cuda", reason="pallas_runtime")
        assert H.is_demoted("conv1d", "cuda")
        H.tick(3)  # the cooldown elapses
        assert H.probation_ready() == [("conv1d", "cuda")]
        assert not H.is_demoted("conv1d", "cuda")  # the one probe
        assert H.is_demoted("conv1d", "cuda")  # the probe is out
        H.note_success("conv1d", "cuda")  # the probe passed
        assert not H.is_demoted("conv1d", "cuda")
        assert H.breaker("conv1d", "cuda") is None
    assert _record(health) == _record(jhealth)
    assert {a for _, _, a, _, _ in _record(health)} == {
        "probe:cuda", "repromote:cuda"}
    assert obs.REGISTRY.counter("health.repromote").value(
        site="conv1d", rung="cuda") == 1.0
    assert not HEALTH.has_breakers


def test_breaker_failed_probe_grows_cooldown(monkeypatch):
    monkeypatch.setenv("REPRO_HEALTH_COOLDOWN_CALLS", "2")
    monkeypatch.setenv("REPRO_HEALTH_COOLDOWN_GROWTH", "2.0")
    for h in (health, jhealth):
        H = h.HEALTH
        H.demote("pool1d", "cuda")
        H.tick(2)
        assert not H.is_demoted("pool1d", "cuda")  # probe granted
        H.demote("pool1d", "cuda")  # the probe failed: trips 2
        br = H.breaker("pool1d", "cuda")
        assert br.trips == 2 and br.state == "open"
        H.tick(2)
        assert H.is_demoted("pool1d", "cuda")  # 2 < 2 x growth
        H.tick(2)
        assert not H.is_demoted("pool1d", "cuda")  # 4 >= 4: next probe
        H.note_success("pool1d", "cuda")
        # the trip history survives repromotion: a new demotion takes 3
        H.demote("pool1d", "cuda")
        assert H.breaker("pool1d", "cuda").trips == 3
    assert _record(health) == _record(jhealth)
    assert _breakers(health) == _breakers(jhealth)


def test_breaker_wall_clock_cooldown_grows_per_trip(monkeypatch):
    """``REPRO_HEALTH_COOLDOWN_S`` on a fake clock, calls off, growth 3:
    the probe waits 2 s after the first trip and 6 s after the second, in
    both packages."""
    monkeypatch.setenv("REPRO_HEALTH_COOLDOWN_CALLS", "0")
    monkeypatch.setenv("REPRO_HEALTH_COOLDOWN_S", "2")
    monkeypatch.setenv("REPRO_HEALTH_COOLDOWN_GROWTH", "3")
    now = [50.0]
    clock = types.SimpleNamespace(perf_counter=lambda: now[0])
    for h in (health, jhealth):
        monkeypatch.setattr(h, "time", clock)
    answers = {h: [] for h in (health, jhealth)}
    for h in (health, jhealth):
        H, got = h.HEALTH, answers[h]
        now[0] = 50.0
        H.demote("conv1d", "cuda", reason="pallas_runtime")
        H.tick(100)  # no call count: ticks do not reach a probe
        now[0] = 51.9
        got.append(H.is_demoted("conv1d", "cuda"))
        now[0] = 52.0
        got.append(H.probation_ready())
        got.append(H.is_demoted("conv1d", "cuda"))  # the probe
        H.demote("conv1d", "cuda", reason="pallas_runtime")  # it failed
        now[0] = 57.9
        got.append(H.is_demoted("conv1d", "cuda"))  # 5.9 s < 2 x 3
        now[0] = 58.0
        got.append(H.is_demoted("conv1d", "cuda"))  # the second probe
        H.note_success("conv1d", "cuda")
        got.append(H.breaker("conv1d", "cuda"))
    assert answers[health] == answers[jhealth] == [
        True, [("conv1d", "cuda")], False, True, False, None]
    assert _record(health) == _record(jhealth)


def test_reason_vocabulary_is_the_references():
    assert ({r.name: r.value for r in health.Reason}
            == {r.name: r.value for r in jhealth.Reason})
    with pytest.raises(ValueError, match="unknown health reason"):
        HEALTH.record("x", "not_a_reason", "y")


@pytest.mark.parametrize("seed", range(12))
def test_breakers_follow_the_reference_call_for_call(seed, monkeypatch):
    """A random sequence of ``demote`` / ``is_demoted`` / ``note_success``
    / ``tick`` / ``probation_ready`` calls and steps of a shared fake
    clock through both packages' health records: the same events (details
    and counts too), breaker states and answers after every call. The
    seeds cover every cooldown knob: calls (0 turns them off), seconds
    (unset, or wall-clock on the fake clock) and the growth per trip."""
    calls, secs, growth = (0, 1, 2, 3)[seed % 4], (None, "1.5")[seed % 2], \
        ("2.0", "3.0", "1.5")[seed % 3]
    if calls == 0 and secs is None:
        secs = "2.5"  # some cooldown elapses
    monkeypatch.setenv("REPRO_HEALTH_COOLDOWN_CALLS", str(calls))
    monkeypatch.setenv("REPRO_HEALTH_COOLDOWN_GROWTH", growth)
    if secs is None:
        monkeypatch.delenv("REPRO_HEALTH_COOLDOWN_S", raising=False)
    else:
        monkeypatch.setenv("REPRO_HEALTH_COOLDOWN_S", secs)
    now = [1000.0]
    clock = types.SimpleNamespace(perf_counter=lambda: now[0])
    for h in (health, jhealth):
        monkeypatch.setattr(h, "time", clock)
    rng = np.random.default_rng(seed)
    sites, impls = ("conv1d", "pool1d"), ("cuda", "plain")
    reasons = ("pallas_compile", "pallas_runtime", "jax_runtime", "bogus")
    for _ in range(60):
        op = rng.integers(6)
        if op == 5:
            now[0] += float(rng.uniform(0.0, 2.0))
            continue
        s, i = sites[rng.integers(2)], impls[rng.integers(2)]
        if op == 0:
            r = reasons[rng.integers(len(reasons))]
            got = [h.HEALTH.demote(s, i, reason=r) for h in (health, jhealth)]
        elif op == 1:
            got = [h.HEALTH.is_demoted(s, i) for h in (health, jhealth)]
        elif op == 2:
            got = [h.HEALTH.note_success(s, i) for h in (health, jhealth)]
        elif op == 3:
            n = int(rng.integers(1, 4))
            got = [h.HEALTH.tick(n) for h in (health, jhealth)]
        else:
            got = [h.HEALTH.probation_ready() for h in (health, jhealth)]
        assert got[0] == got[1]
        assert _breakers(health, True) == _breakers(jhealth, True)
        assert _record(health) == _record(jhealth)
        assert HEALTH.has_breakers == bool(HEALTH._breakers)
    assert HEALTH.demotions() == jhealth.HEALTH.demotions()


def test_runtime_demote_probe_cycle_through_the_ladder(rng, on_card,
                                                       monkeypatch):
    """The whole circuit through the real ladder: a runtime trip demotes
    (the catch layer's ``demote_tripped``), the plain rung's clean calls
    run the cooldown, the probe fails on the second armed fault and
    re-demotes with a grown cooldown, the next probe passes and
    repromotes."""
    monkeypatch.setenv("REPRO_HEALTH_COOLDOWN_CALLS", "1")
    x = rng.normal(size=(1, 32, 4)).astype(np.float32)
    w = rng.normal(size=(3, 4)).astype(np.float32)

    def call():
        out = tops.conv1d_depthwise(_t(x), _t(w))
        try:
            faults.raise_pending("cpu")
        except faults.FaultError as e:
            health.demote_tripped(faults.consume_trip(), e)
        return out

    clean = call()
    with faults.inject("pallas_runtime", site="conv1d_depthwise", times=2):
        call()  # trip 1
        assert HEALTH.breaker("conv1d_depthwise", "cuda").trips == 1
        call()  # plain serves: clean 1 >= 1
        call()  # the probe takes the second fault: trip 2
        br = HEALTH.breaker("conv1d_depthwise", "cuda")
        assert br.trips == 2 and br.state == "open"
        call()
        call()  # the grown cooldown (2) reached
        _close(call(), clean)  # the probe passes: repromoted
    assert HEALTH.breaker("conv1d_depthwise", "cuda") is None
    acts = [e.action for e in HEALTH.events_for("conv1d_depthwise")]
    assert acts == ["demote:cuda(runtime)", "probe:cuda", "repromote:cuda"]


# -- serve: retry, quarantine, the runtime drill, journal replay -----------------

@pytest.fixture(scope="module")
def shared():
    """whisper's smoke config with the reference's weights in both
    packages, CI's prompts, and the reference's clean greedy tokens."""
    jcfg = jsmoke_config(jget_config("whisper-medium"))
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.key(0))
    prompts = np.random.default_rng(0).integers(
        2, jcfg.vocab_size, size=(B, P)).astype(np.int32)
    want, want_done = jserve.generate(jm, jp, jnp.asarray(prompts),
                                      gen_len=GEN, cache_len=CACHE_LEN)
    jhealth.HEALTH.reset()
    cfg = smoke_config(get_config("whisper-medium"))
    tm = build_model(cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                           defs=tm.param_defs())
    pallas = build_model(cfg.replace(conv_backend="sliding_pallas"))
    return dict(jm=jm, jp=jp, tm=tm, tp=tp, pallas=pallas, prompts=prompts,
                want=np.asarray(want), want_done=np.asarray(want_done))


def _gen(model, params, prompts, **kw):
    return serve.generate(model, params, torch.from_numpy(prompts),
                          gen_len=GEN, cache_len=CACHE_LEN, **kw)


def _serve_events(h):
    return [e for e in _events(h) if e[0].startswith("serve/")]


def test_serve_retry_recovers_nan_logits(shared):
    with faults.inject("nan_activations", site="serve/logits", times=1), \
            jfaults.inject("nan_activations", site="serve/logits", times=1):
        toks, _ = _gen(shared["tm"], shared["tp"], shared["prompts"])
        jserve.generate(shared["jm"], shared["jp"],
                        jnp.asarray(shared["prompts"]), gen_len=GEN,
                        cache_len=CACHE_LEN)
    np.testing.assert_array_equal(toks.numpy(), shared["want"])
    assert _serve_events(health) == _serve_events(jhealth) == [
        ("serve/generate", "nan_logits", "retry")]


def test_serve_retries_exhausted_raises(shared):
    with faults.inject("nan_activations", site="serve/logits"):
        with pytest.raises(FloatingPointError):
            _gen(shared["tm"], shared["tp"], shared["prompts"], max_retries=1)
    assert [a for _, _, a in _serve_events(health)] == [
        "retry", "error:retries_exhausted"]


def test_serve_slot_quarantine_siblings_token_exact(shared):
    with faults.inject("nan_activations", site="serve/slot.1", times=1), \
            jfaults.inject("nan_activations", site="serve/slot.1", times=1):
        toks, done = _gen(shared["tm"], shared["tp"], shared["prompts"])
        jtoks, jdone = jserve.generate(
            shared["jm"], shared["jp"], jnp.asarray(shared["prompts"]),
            gen_len=GEN, cache_len=CACHE_LEN)
    np.testing.assert_array_equal(toks[0].numpy(), shared["want"][0])
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    assert bool(done[1]) and bool(np.asarray(jdone)[1])
    assert (toks[1] == shared["tm"].cfg.eos_id).all()
    assert _serve_events(health) == _serve_events(jhealth) == [
        ("serve/slot", "nan_logits", "quarantine")]


def test_serve_slow_step_sleeps_each_decode_step(shared):
    with faults.inject("slow_step", site="serve", delay_s=0.01) as inj:
        _gen(shared["tm"], shared["tp"], shared["prompts"])
    assert inj.fired == GEN - 1


def test_serve_runtime_fault_demotes_and_reruns_token_exact(shared):
    """A trip of the conv frontend at run time (``nan_activations`` at the
    plain rung: the CPU has no cuda rung) surfaces after the prefill,
    demotes ``plain``, and the re-run on ``ref`` emits the reference's
    tokens; the retry budget is not spent."""
    with faults.inject("nan_activations", site="conv1d", times=1):
        toks, _ = _gen(shared["pallas"], shared["tp"], shared["prompts"],
                       max_retries=0)
    np.testing.assert_array_equal(toks.numpy(), shared["want"])
    assert _events(health) == [("conv1d", "nan_activations",
                                "demote:plain(runtime)")]
    assert HEALTH.is_demoted("conv1d", "plain")
    reg = obs.REGISTRY
    assert sum(v for _, v in reg.counter("runtime.demote").series()) == 1.0
    assert reg.counter("runtime.retrace_ms").value(arch="whisper-medium") > 0
    assert reg.counter("serve.retries").series() == []


def test_serve_sentinel_demotes_a_kernel_that_emits_nan(shared,
                                                       monkeypatch):
    """With ``REPRO_RUNTIME_SENTINEL`` and no injection: a conv frontend
    whose first call returns NaN trips the sentinel's device flag, read at
    the prefill's ``raise_pending``. Nothing was injected, so the sentinel
    demotes nothing: the request fails with the trip's ``FaultError`` and
    an ``error:plain(sentinel)`` event, with no breaker, no re-run and no
    retry."""
    real = sliding_conv1d.conv1d_sliding
    calls = []

    def poisoned(*a, **k):
        out = real(*a, **k)
        calls.append(1)
        return torch.full_like(out, float("nan")) if len(calls) == 1 else out

    monkeypatch.setattr(sliding_conv1d, "conv1d_sliding", poisoned)
    monkeypatch.setenv(faults.SENTINEL_ENV, "1")
    faults.reload_env()
    with pytest.raises(faults.FaultError) as ei:
        _gen(shared["pallas"], shared["tp"], shared["prompts"])
    assert (ei.value.kind, ei.value.site) == ("nan_activations", "conv1d")
    assert len(calls) == 2  # the prefill's two convs, no re-run
    assert _events(health) == [("conv1d", "nan_activations",
                                "error:plain(sentinel)")]
    assert not HEALTH.has_breakers
    reg = obs.REGISTRY
    assert reg.counter("runtime.demote").series() == []
    assert reg.counter("runtime.retrace_ms").series() == []
    assert reg.counter("serve.retries").series() == []


def test_serve_probation_repromotes_across_requests(shared, monkeypatch,
                                                    capsys):
    monkeypatch.setenv("REPRO_HEALTH_COOLDOWN_CALLS", "2")
    with faults.inject("nan_activations", site="conv1d", times=1):
        got1, _ = _gen(shared["pallas"], shared["tp"], shared["prompts"])
        br = HEALTH.breaker("conv1d", "plain")  # non-mutating
        assert br is not None and br.state == "open" and br.trips == 1
        got2, _ = _gen(shared["pallas"], shared["tp"], shared["prompts"])
    for got in (got1, got2):
        np.testing.assert_array_equal(got.numpy(), shared["want"])
    acts = [a for _, _, a in _events(health, "conv1d")]
    assert acts == ["demote:plain(runtime)", "probe:plain", "repromote:plain"]
    assert HEALTH.breaker("conv1d", "plain") is None
    assert "action=probe:plain" in capsys.readouterr().err


def test_serve_runtime_demotions_are_capped(shared, monkeypatch):
    """A trip on every attempt: after ``_MAX_RUNTIME_DEMOTIONS`` re-runs
    the fault propagates."""
    monkeypatch.setattr(serve, "_MAX_RUNTIME_DEMOTIONS", 2)
    with faults.inject("nan_activations", site="conv1d"):
        with pytest.raises(faults.FaultError):
            _gen(shared["pallas"], shared["tp"], shared["prompts"])
    assert sum(v for _, v in obs.REGISTRY.counter(
        "runtime.demote").series()) == 3.0


def test_serve_unattributed_fault_propagates(shared):
    """A ``FaultError`` with no trip (every rung of a site faulted) is not
    a runtime trip and is not retried."""
    with faults.inject("jax_runtime", site="attention_decode"):
        HEALTH.demote("attention_decode", "ref")
        with pytest.raises(faults.FaultError):
            _gen(shared["tm"], shared["tp"], shared["prompts"])
    assert obs.REGISTRY.counter("serve.retries").series() == []


def test_serve_journal_replay_under_a_runtime_fault(shared, tmp_path):
    """A begin without an end (stopped in flight) replays, through a
    runtime demotion, to the reference's greedy tokens and closes the
    journal."""
    j = serve.RequestJournal(tmp_path)
    j.begin("r1", torch.from_numpy(shared["prompts"]), gen_len=GEN,
            cache_len=CACHE_LEN, temperature=0.0, seed=0)
    with faults.inject("nan_activations", site="conv1d", times=1):
        ((rid, toks, done),) = serve.replay_pending(
            shared["pallas"], shared["tp"], j, device=torch.device("cpu"))
    assert rid == "r1" and j.pending() == []
    np.testing.assert_array_equal(toks.numpy(), shared["want"])
    np.testing.assert_array_equal(done.numpy(), shared["want_done"])
    assert HEALTH.events_for("conv1d", reason="nan_activations")


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env.pop("REPRO_FAULTS", None)
    env.update(extra)
    return env


def _ci_chaos_checks() -> str:
    """The python checks of CI's "Serve smoke under runtime fault + slot
    poison" step, read from the workflow file, with the rung names and the
    fault kind of the CPU drill: ``plain`` for ``pallas``, and
    ``nan_activations`` for ``pallas_runtime`` (the CPU has no cuda rung,
    so the drill fires at the plain rung's trap)."""
    lines = CI.read_text().splitlines()
    name = "- name: Serve smoke under runtime fault + slot poison"
    i = next(n for n, ln in enumerate(lines) if ln.strip() == name)
    start = next(n for n in range(i, len(lines))
                 if lines[n].strip() == "python - <<'EOF'")
    end = next(n for n in range(start, len(lines)) if lines[n].strip() == "EOF")
    import textwrap

    body = textwrap.dedent("\n".join(lines[start + 1:end]))
    for a, b in (('"pallas_runtime"', '"nan_activations"'),
                 ("demote:pallas(runtime)", "demote:plain(runtime)"),
                 ("probe:pallas", "probe:plain"),
                 ("repromote:pallas", "repromote:plain")):
        assert a in body, a
        body = body.replace(a, b)
    return body


def test_ci_runtime_chaos_smoke_passes_on_the_port(tmp_path):
    """CI's runtime chaos step on the port's CLI (``--device cpu``): a
    clean ``--conv-backend sliding`` run, then the drill with a runtime
    trip of the conv frontend and one poisoned slot, two requests and a
    run dir; CI's checks (tokens, events, metrics.json, the journal)."""
    common = ["--arch", "whisper-medium", "--smoke", "--batch", str(B),
              "--prompt-len", str(P), "--gen", str(GEN), "--requests", "2",
              "--device", "cpu"]
    clean = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *common,
         "--conv-backend", "sliding"], cwd=tmp_path, capture_output=True,
        text=True, timeout=600, env=_env())
    assert clean.returncode == 0, clean.stderr[-3000:]
    chaos = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *common,
         "--conv-backend", "sliding_pallas", "--run-dir", "run_rt_chaos"],
        cwd=tmp_path, capture_output=True, text=True, timeout=600,
        env=_env(REPRO_FAULTS="nan_activations:conv1d*1,"
                              "nan_activations:serve/slot.1*1",
                 REPRO_HEALTH_COOLDOWN_CALLS="4"))
    assert chaos.returncode == 0, chaos.stderr[-3000:]
    (tmp_path / "serve_rt_clean.log").write_text(clean.stdout)
    (tmp_path / "serve_rt_chaos.log").write_text(chaos.stdout)
    ok = subprocess.run([sys.executable, "-c", _ci_chaos_checks()],
                        cwd=tmp_path, capture_output=True, text=True,
                        timeout=60)
    assert ok.returncode == 0, ok.stderr


# -- train: the runtime catch layer -----------------------------------------------

def _train_args(run_dir, steps=3):
    return argparse.Namespace(
        arch="whisper-medium", smoke=True, steps=steps, batch=2, seq=16,
        lr=3e-4, seed=0, run_dir=str(run_dir), ckpt_every=0, log_every=10,
        grad_accum=None, conv_backend="sliding_pallas", audio_frontend="mels",
        no_resume=True, fail_at=None, device="cpu")


def test_train_runtime_fault_demotes_retries_and_recovers(tmp_path,
                                                          monkeypatch):
    """A trip at step 0 demotes the rung, the same step is retried on the
    untouched state (its loss the clean run's), the optimizer counts each
    step once, and the rung repromotes after its cooldown."""
    from repro_torch.launch import steps as steps_mod

    steps_seen = []
    real = steps_mod.apply_updates

    def counting(params, grads, opt, cfg):
        out = real(params, grads, opt, cfg)
        steps_seen.append(int(out[1]["count"]))
        return out

    monkeypatch.setattr(steps_mod, "apply_updates", counting)
    clean = ttrain.train_loop(_train_args(tmp_path / "clean"))
    n_clean = list(steps_seen)
    steps_seen.clear()
    HEALTH.reset()
    obs.REGISTRY.reset()
    monkeypatch.setenv("REPRO_HEALTH_COOLDOWN_CALLS", "2")
    with faults.inject("nan_activations", site="conv1d", times=1):
        chaos = ttrain.train_loop(_train_args(tmp_path / "chaos"))
    assert np.isfinite(chaos["losses"]).all()
    np.testing.assert_allclose(chaos["losses"][0], clean["losses"][0],
                               rtol=1e-5)
    np.testing.assert_allclose(chaos["losses"], clean["losses"], rtol=1e-4)
    assert steps_seen == n_clean == [1, 2, 3]
    acts = [a for _, _, a in _events(health, "conv1d")]
    assert acts == ["demote:plain(runtime)", "probe:plain", "repromote:plain"]
    reg = obs.REGISTRY
    assert reg.counter("runtime.retrace_ms").value(arch="whisper-medium") > 0
    assert reg.counter("health.repromote").value(site="conv1d",
                                                 rung="plain") == 1.0


@pytest.mark.parametrize("accum", [1, 2])
def test_tripped_step_leaves_the_state_untouched(accum):
    """The port's AdamW updates in place, so the trip must surface before
    it: a step whose kernels tripped raises and leaves the params, the
    moments and the step count as they were, and its retry equals a clean
    step on a copy of the state (grad accumulation too)."""
    from repro_torch.distributed.sharding import iter_leaves, map_tree
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import OptConfig, init_opt_state

    cfg = smoke_config(get_config("whisper-medium")).replace(
        conv_backend="sliding_pallas")
    model = build_model(cfg)
    with torch.no_grad():
        params = model.init(torch.Generator().manual_seed(0))
    opt_cfg = OptConfig(lr=1e-3, total_steps=4, warmup_steps=1)
    state = {"params": params, "opt": init_opt_state(params, opt_cfg)}
    rng = np.random.default_rng(0)
    toks = rng.integers(2, cfg.vocab_size, size=(2, 17)).astype(np.int64)
    batch = {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
             "labels": torch.from_numpy(toks[:, 1:].astype(np.int32)),
             "frames": torch.from_numpy(rng.normal(
                 size=(2, 16, 80)).astype(np.float32))}
    step_fn = make_train_step(model, opt_cfg, accum_steps=accum)
    before = map_tree(lambda t: t.clone(), state)
    with faults.inject("nan_activations", site="conv1d", times=1):
        with pytest.raises(faults.FaultError):
            step_fn(state, batch)
    for (pa, a), (pb, b) in zip(iter_leaves(state), iter_leaves(before)):
        assert pa == pb
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert faults.consume_trip().site == "conv1d"
    twin = map_tree(lambda t: t.clone(), before)
    s1, m1 = step_fn(state, batch)  # the retry
    s2, m2 = step_fn(twin, batch)  # a clean step on a copy
    assert float(m1["loss"]) == float(m2["loss"])
    assert int(s1["opt"]["count"]) == int(s2["opt"]["count"]) == 1
    for (_, a), (_, b) in zip(iter_leaves(s1), iter_leaves(s2)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_train_sentinel_trip_fails_the_step(tmp_path, monkeypatch):
    """With ``REPRO_RUNTIME_SENTINEL`` and no injection, a conv frontend
    whose first call returns NaN fails step 0 at its loss: the trip's
    ``FaultError`` propagates with an ``error:plain(sentinel)`` event, no
    breaker and no optimizer step, and the step is not retried."""
    from repro_torch.launch import steps as steps_mod

    real_conv = sliding_conv1d.conv1d_sliding
    calls, counts = [], []

    def poisoned(*a, **k):
        out = real_conv(*a, **k)
        calls.append(1)
        if len(calls) > 1:
            return out
        if isinstance(out, tuple):
            return tuple(torch.full_like(t, float("nan")) for t in out)
        return torch.full_like(out, float("nan"))

    real_apply = steps_mod.apply_updates

    def counting(params, grads, opt, cfg):
        out = real_apply(params, grads, opt, cfg)
        counts.append(int(out[1]["count"]))
        return out

    monkeypatch.setattr(sliding_conv1d, "conv1d_sliding", poisoned)
    monkeypatch.setattr(steps_mod, "apply_updates", counting)
    monkeypatch.setenv(faults.SENTINEL_ENV, "1")
    faults.reload_env()
    with pytest.raises(faults.FaultError) as ei:
        ttrain.train_loop(_train_args(tmp_path))
    assert (ei.value.kind, ei.value.site) == ("nan_activations", "conv1d")
    assert counts == []
    assert len(calls) == 3  # step 0's two convs and conv2's dx, no retry
    assert "(sentinel)" in str(ei.value)
    assert _events(health) == [("conv1d", "nan_activations",
                                "error:plain(sentinel)")]
    assert not HEALTH.has_breakers
    assert obs.REGISTRY.counter("runtime.demote").series() == []
    monkeypatch.delenv(faults.SENTINEL_ENV)
    faults.reset()


def test_train_slow_step(tmp_path):
    with faults.inject("slow_step", site="train", delay_s=0.01) as inj:
        ttrain.train_loop(_train_args(tmp_path, steps=2))
    assert inj.fired == 2


def test_the_combinations_of_sites_and_rungs_are_the_references():
    """The reference's eight ladder sites are the port's; each has the
    reference's rung count on a CUDA tensor."""
    assert tuple(sorted(_entries(np.random.default_rng(0)))) == SITES
    src = (ROOT / "src" / "repro_torch" / "kernels" / "ops.py").read_text()
    assert src.count("return _ladder(") + src.count("out = _ladder(") == 8
