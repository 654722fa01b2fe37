"""The port's serve and train CLIs on their run substrate, on the CPU.

CI's traced serve smoke and its obs report step (``.github/workflows/
ci.yml``) run on the port's CLI with their checks taken from the workflow
file itself, only the module name changed; the request journal, the
deadline, load shedding, slot quarantine and the retry bound of
``repro_torch.launch.serve`` at whisper-medium's smoke config; the journal
and the deadline against the reference on shared weights (the reference
makes them, ``bridge.params_from_numpy`` carries them across); and the
train CLI under ``--trace``.
"""
import json
import os
import pathlib
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke_config  # noqa: E402
from repro.distributed import ft as jft  # noqa: E402
from repro.kernels import autotune as jautotune  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro_torch import health, obs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.distributed import ft  # noqa: E402
from repro_torch.health import HEALTH  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.obs import report as obs_report  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CI = ROOT / ".github" / "workflows" / "ci.yml"
B, P, GEN = 2, 16, 8  # CI's request
CACHE_LEN = 2 * (P + GEN)  # the enc-dec cache both CLIs size


@pytest.fixture(autouse=True)
def _clean_state():
    """Tracing off, an empty registry, trace ring, health record and
    attention log before and after each test (all process-global)."""
    def reset():
        obs.enable(False)
        tops.ATTN_DECODE_DISPATCH.clear()
        obs.REGISTRY.reset()
        obs_trace.clear()
        HEALTH.reset()
    reset()
    yield
    reset()


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra)
    return env


def _ci_step(name: str) -> tuple[str, str]:
    """A CI step's shell command ahead of its heredoc, and the python
    heredoc itself, read from the workflow file."""
    lines = CI.read_text().splitlines()
    i = next(n for n, ln in enumerate(lines) if ln.strip() == f"- name: {name}")
    start = next(n for n in range(i, len(lines))
                 if lines[n].strip() == "python - <<'EOF'")
    end = next(n for n in range(start, len(lines)) if lines[n].strip() == "EOF")
    command = " ".join(ln.strip().rstrip("\\").strip()
                       for ln in lines[i + 2:start])
    return command, textwrap.dedent("\n".join(lines[start + 1:end]))


def test_ci_traced_serve_smoke_and_report_pass_on_the_port(tmp_path):
    """CI's traced serve smoke on the port's CLI (``--device cpu``) into a
    run directory that does not exist beforehand, then CI's checks of
    ``metrics.json`` and ``trace.json`` and of the report's needles, as
    the workflow file has them."""
    command, checks = _ci_step("Traced serve smoke")
    assert command.startswith("REPRO_TRACE=1 PYTHONPATH=src python -m "
                              "repro.launch.serve")
    argv = command.split("repro.launch.serve", 1)[1].split("|")[0].split()
    assert argv == ["--arch", "whisper-medium", "--smoke", "--batch", "2",
                    "--prompt-len", "16", "--gen", "8", "--kv-quant", "int8",
                    "--run-dir", "obs_run"]
    assert not (tmp_path / "obs_run").exists()
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *argv,
         "--device", "cpu"], cwd=tmp_path, capture_output=True, text=True,
        timeout=600, env=_env(REPRO_TRACE="1"))
    assert run.returncode == 0, run.stderr[-3000:]
    ok = subprocess.run([sys.executable, "-c", checks], cwd=tmp_path,
                        capture_output=True, text=True, timeout=60)
    assert ok.returncode == 0, ok.stderr

    command, needles = _ci_step("Obs report rebuilds serve summary from "
                                "artifacts")
    assert "python -m repro.obs report obs_run" in command
    rep = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "report", "obs_run"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120, env=_env())
    assert rep.returncode == 0, rep.stderr
    (tmp_path / "obs_report.log").write_text(rep.stdout)
    ok = subprocess.run([sys.executable, "-c", needles], cwd=tmp_path,
                        capture_output=True, text=True, timeout=60)
    assert ok.returncode == 0, ok.stderr
    assert (tmp_path / "obs_run" / "heartbeats" / "host_0").exists()


def test_help_lists_the_run_substrate_flags(capsys):
    with pytest.raises(SystemExit):
        serve.main(["--help"])
    text = capsys.readouterr().out
    for flag in ("--run-dir", "--trace", "--requests", "--deadline-s",
                 "--retries"):
        assert flag in text, flag
    assert not hasattr(serve, "NOT_PORTED")


def _serve_cli(run_dir, *extra):
    serve.main(["--arch", "whisper-medium", "--smoke", "--batch", str(B),
                "--prompt-len", str(P), "--gen", str(GEN), "--kv-quant",
                "int8", "--device", "cpu", "--run-dir", str(run_dir), *extra])


def _samples(text: str) -> dict:
    """``{request id: sample}`` from the CLI's ``sample[id]:`` lines."""
    return dict(re.findall(r"^\[serve\] sample\[(\w+)\]: (.*)$", text,
                           re.MULTILINE))


def test_requests_journal_closes_every_begin(tmp_path, capsys):
    """``--requests 2``: two begins, each closed by its end, and equal
    samples; a later process with a begin left open replays it first."""
    run_dir = tmp_path / "fresh" / "run"
    _serve_cli(run_dir, "--requests", "2")
    out = capsys.readouterr().out
    samples = _samples(out)
    assert samples.keys() == {"req0", "req1"}
    assert samples["req0"] == samples["req1"]
    recs = serve.RequestJournal(run_dir).records()
    assert [(r["id"], r["event"]) for r in recs] == [
        ("req0", "begin"), ("req0", "end"), ("req1", "begin"), ("req1", "end")]
    assert serve.RequestJournal(run_dir).pending() == []
    assert recs[1]["tokens"] == recs[3]["tokens"]

    # a process stopped between admission and completion
    j = serve.RequestJournal(run_dir)
    j.begin("lost", torch.tensor(recs[0]["prompts"], dtype=torch.int32),
            gen_len=GEN, cache_len=recs[0]["cache_len"], temperature=0.0,
            seed=0)
    obs.REGISTRY.reset()
    _serve_cli(run_dir)
    out = capsys.readouterr().out
    assert "[serve] journal: replayed in-flight request lost" in out
    assert _samples(out)["lost"] == samples["req0"]
    assert j.pending() == []
    assert j.records()[-3]["tokens"] == recs[1]["tokens"]  # lost's end
    assert obs.REGISTRY.counter("serve.journal_replayed").value() == 1.0


@pytest.fixture(scope="module")
def shared():
    """whisper's smoke config (float32, fp cache) with the reference's
    weights in both packages, CI's prompts, and the reference's greedy
    tokens for one uninterrupted request and for one at deadline 0."""
    jcfg = jsmoke_config(jget_config("whisper-medium"))
    jm = jbuild_model(jcfg)
    jp = jm.init(jax.random.key(0))
    prompts = np.random.default_rng(0).integers(
        2, jcfg.vocab_size, size=(B, P)).astype(np.int32)
    want, want_done = jserve.generate(jm, jp, jnp.asarray(prompts),
                                      gen_len=GEN, cache_len=CACHE_LEN)
    cut, cut_done = jserve.generate(jm, jp, jnp.asarray(prompts), gen_len=GEN,
                                    cache_len=CACHE_LEN, deadline_s=0.0)
    jserve.HEALTH.reset()
    tm = build_model(smoke_config(get_config("whisper-medium")))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu",
                           defs=tm.param_defs())
    return dict(jm=jm, jp=jp, tm=tm, tp=tp, prompts=prompts,
                want=np.asarray(want), want_done=np.asarray(want_done),
                cut=np.asarray(cut), cut_done=np.asarray(cut_done))


def test_journal_replay_reproduces_the_reference_tokens(shared, tmp_path):
    """The reference journals a request's begin and stops; the port
    replays it from the reference's journal on the reference's weights
    and its greedy tokens equal the reference's uninterrupted ones bit for
    bit. The port's records carry the reference's keys."""
    run_dir = tmp_path / "run"
    run_dir.mkdir()  # the reference's journal does not make it
    jj = jserve.RequestJournal(run_dir)
    jj.begin("req0", jnp.asarray(shared["prompts"]), gen_len=GEN,
             cache_len=CACHE_LEN, temperature=0.0, seed=0)
    out = serve.replay_pending(shared["tm"], shared["tp"],
                               serve.RequestJournal(run_dir),
                               device=torch.device("cpu"))
    (rid, toks, done), = out
    assert rid == "req0"
    np.testing.assert_array_equal(toks.numpy(), shared["want"])
    np.testing.assert_array_equal(done.numpy(), shared["want_done"])
    # the replay journals its begin again, as the reference's does, then
    # the end the stopped process never wrote; the reference reads both
    begin, again, end = jj.records()
    assert again == begin and jj.pending() == []
    assert end["tokens"] == shared["want"].tolist()

    # the reference's own begin and end records, key for key
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    jserve.generate(shared["jm"], shared["jp"], jnp.asarray(shared["prompts"]),
                    gen_len=GEN, cache_len=CACHE_LEN,
                    journal=jserve.RequestJournal(ref_dir), request_id="req0")
    ref_begin, ref_end = jserve.RequestJournal(ref_dir).records()
    port_dir = tmp_path / "port"  # made by the port's journal
    serve.generate(shared["tm"], shared["tp"],
                   torch.from_numpy(shared["prompts"]), gen_len=GEN,
                   cache_len=CACHE_LEN, journal=serve.RequestJournal(port_dir),
                   request_id="req0")
    port_begin, port_end = serve.RequestJournal(port_dir).records()
    assert port_begin == ref_begin  # the same request, value for value
    assert port_end.keys() == ref_end.keys() == end.keys()
    assert port_end == ref_end


def test_deadline_zero_truncates_at_the_first_step(shared):
    """``deadline_s=0`` admits the request and truncates it after its first
    decode step: the tokens and done mask equal the reference's, and the
    event is recorded as the reference records it."""
    toks, done = serve.generate(
        shared["tm"], shared["tp"], torch.from_numpy(shared["prompts"]),
        gen_len=GEN, cache_len=CACHE_LEN, deadline_s=0.0)
    np.testing.assert_array_equal(toks.numpy(), shared["cut"])
    np.testing.assert_array_equal(done.numpy(), shared["cut_done"])
    eos = shared["tm"].cfg.eos_id
    assert (toks[:, 2:] == eos).all() and done.all()
    (ev,) = HEALTH.events
    assert (ev.site, ev.reason, ev.action) == (
        "serve/generate", "deadline_exceeded", "truncate")
    assert ev.detail == f"2/{GEN} tokens in 0.0s"
    arch = shared["tm"].cfg.name
    assert obs.REGISTRY.counter("serve.deadline_exceeded").value(
        arch=arch) == 1.0
    assert obs.REGISTRY.histogram("serve.decode_step_s").count(arch=arch) == 1


def test_load_shed_after_eight_slow_steps(shared):
    """Admission trusts the decode-step p95 from eight samples on: seven
    slow steps admit, the eighth makes the projection (p95 x gen_len)
    exceed the deadline and the request is shed before it is journaled."""
    tm, tp = shared["tm"], shared["tp"]
    arch = tm.cfg.name
    hist = obs.REGISTRY.histogram("serve.decode_step_s")
    for _ in range(7):
        hist.observe(1.0, arch=arch)
    serve._admission_check(tm, GEN, 2.0)  # too few samples to judge
    hist.observe(1.0, arch=arch)
    with pytest.raises(serve.LoadShedError, match="exceeds deadline 2.0s"):
        serve.generate(tm, tp, torch.from_numpy(shared["prompts"]),
                       gen_len=GEN, cache_len=CACHE_LEN, deadline_s=2.0)
    assert obs.REGISTRY.counter("serve.shed").value(arch=arch) == 1.0
    assert obs.REGISTRY.counter("serve.requests").value(arch=arch) == 0.0
    (ev,) = HEALTH.events
    assert (ev.site, ev.reason, ev.action) == (
        "serve/admission", "load_shed", "shed")
    # a budget the projection fits, and the force-truncate idiom, admit
    serve._admission_check(tm, GEN, 100.0)
    serve._admission_check(tm, GEN, 0.0)


def _poisoned(model, rows, at_step):
    """``model.decode_step`` with the logits of ``rows`` set to NaN at
    decode call ``at_step``."""
    clean = model.decode_step
    calls = [0]

    def decode_step(*a, **kw):
        logits, cache = clean(*a, **kw)
        if calls[0] == at_step:
            logits = logits.clone()
            logits[rows] = float("nan")
        calls[0] += 1
        return logits, cache

    return decode_step


def test_nan_in_one_slot_quarantines_that_slot_only(shared, monkeypatch):
    tm, tp = shared["tm"], shared["tp"]
    prompts = torch.from_numpy(shared["prompts"])
    monkeypatch.setattr(tm, "decode_step", _poisoned(tm, [1], at_step=2))
    toks, done = serve.generate(tm, tp, prompts, gen_len=GEN,
                                cache_len=CACHE_LEN)
    np.testing.assert_array_equal(toks[0].numpy(), shared["want"][0])
    np.testing.assert_array_equal(toks[1, :3].numpy(), shared["want"][1, :3])
    assert (toks[1, 3:] == tm.cfg.eos_id).all()
    assert done.tolist() == [bool(shared["want_done"][0]), True]
    (ev,) = HEALTH.events
    assert (ev.site, ev.reason, ev.action, ev.detail) == (
        "serve/slot", "nan_logits", "quarantine", "step 2: 1 slot(s) [1]")
    assert obs.REGISTRY.counter("serve.quarantined").value(
        arch=tm.cfg.name) == 1.0


def test_nan_in_every_slot_retries_then_raises(shared, monkeypatch):
    """Non-finite logits in every slot re-run the request up to
    ``max_retries`` times; a transient fault heals on the retry, a
    persistent one raises after the budget, each recorded as the
    reference records it."""
    tm, tp = shared["tm"], shared["tp"]
    prompts = torch.from_numpy(shared["prompts"])
    clean = tm.decode_step
    monkeypatch.setattr(tm, "decode_step", _poisoned(tm, [0, 1], at_step=1))
    toks, _ = serve.generate(tm, tp, prompts, gen_len=GEN,
                             cache_len=CACHE_LEN, max_retries=1)
    np.testing.assert_array_equal(toks.numpy(), shared["want"])
    assert [(e.reason, e.action) for e in HEALTH.events] == [
        ("nan_logits", "retry")]
    assert obs.REGISTRY.counter("serve.retries").value(arch=tm.cfg.name) == 1.0

    HEALTH.reset()

    def every_time(*a, **kw):
        logits, cache = clean(*a, **kw)
        return torch.full_like(logits, float("nan")), cache

    monkeypatch.setattr(tm, "decode_step", every_time)
    with pytest.raises(FloatingPointError, match="non-finite logits"):
        serve.generate(tm, tp, prompts, gen_len=GEN, cache_len=CACHE_LEN,
                       max_retries=1)
    assert [(e.site, e.reason, e.action) for e in HEALTH.events] == [
        ("serve/generate", "nan_logits", "retry"),
        ("serve/generate", "nan_logits", "error:retries_exhausted")]


def test_other_errors_propagate_without_retry(shared, monkeypatch):
    tm, tp = shared["tm"], shared["tp"]

    def broken(*a, **kw):
        raise RuntimeError("device fault")

    monkeypatch.setattr(tm, "decode_step", broken)
    with pytest.raises(RuntimeError, match="device fault"):
        serve.generate(tm, tp, torch.from_numpy(shared["prompts"]),
                       gen_len=GEN, cache_len=CACHE_LEN)
    assert HEALTH.events == []
    assert obs.REGISTRY.counter("serve.retries").value(arch=tm.cfg.name) == 0


def test_run_dir_beats_and_flags_stragglers(shared, tmp_path, monkeypatch):
    """With ``run_dir`` every decode step writes host 0's heartbeat, and the
    default watchdog flags a step over 3x the EMA after its warm-up of 5
    steps: the last of 7 decode steps, slowed by half a second."""
    import time

    tm, tp = shared["tm"], shared["tp"]
    clean, calls = tm.decode_step, [0]

    def slow_last(*a, **kw):
        calls[0] += 1
        if calls[0] == GEN - 1:
            time.sleep(0.5)
        return clean(*a, **kw)

    monkeypatch.setattr(tm, "decode_step", slow_last)
    serve.generate(tm, tp, torch.from_numpy(shared["prompts"]), gen_len=GEN,
                   cache_len=CACHE_LEN, run_dir=tmp_path)
    assert ("serve/decode", "straggler", "flag") in {
        (e.site, e.reason, e.action) for e in HEALTH.events}
    assert obs.REGISTRY.counter("serve.stragglers").value() >= 1.0
    assert (tmp_path / "heartbeats" / "host_0").exists()
    assert ft.stale_hosts(tmp_path, timeout_s=600.0) == []
    assert ft.stale_hosts(tmp_path, timeout_s=-1.0) == [0]


def test_stale_hosts_matches_the_reference(tmp_path):
    hb = tmp_path / "heartbeats"
    hb.mkdir()
    (hb / "host_0").write_text("0")           # ancient
    (hb / "host_1").write_text("")            # torn
    (hb / "host_7").write_text("1e18")        # fresh
    (hb / "host_x").write_text("0")           # not a host
    (hb / ".host_2.123.tmp").write_text("0")  # a write in flight
    for timeout in (1.0, 1e30):
        assert (ft.stale_hosts(tmp_path, timeout_s=timeout)
                == jft.stale_hosts(tmp_path, timeout_s=timeout))
    assert ft.stale_hosts(tmp_path, timeout_s=1.0) == [0, 1]
    assert ft.stale_hosts(tmp_path / "none", timeout_s=1.0) == []


def test_canon_reason_and_conv1d_key_match_the_reference():
    from repro.health import canon_reason as jcanon

    class Kinded(Exception):
        kind = "load_shed"

    for exc, default in ((FloatingPointError("x"), None),
                         (ValueError("x"), None), (Kinded(), None),
                         (ValueError("x"), "straggler"),
                         (ValueError("x"), "no_such_reason")):
        assert health.canon_reason(exc, default) == jcanon(exc, default)
    for args in ((4, 514, 80, 1024, 3, 1, "bfloat16"),
                 (2, 66, 128, 128, 3, 2, "w8a8")):
        assert autotune.conv1d_key(*args) == jautotune.conv1d_key(*args)
        assert (autotune.conv1d_key(*args, grad=True)
                == jautotune.conv1d_key(*args, grad=True))


def test_train_cli_trace_writes_trace_json(tmp_path, capsys):
    out = ttrain.main([
        "--arch", "whisper-medium", "--smoke", "--device", "cpu",
        "--steps", "3", "--batch", "2", "--seq", "32", "--audio-frontend",
        "mels", "--conv-backend", "sliding_pallas", "--run-dir",
        str(tmp_path), "--trace", "--log-every", "100"])
    assert len(out["losses"]) == 3
    evs = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    assert [e["args"]["step"] for e in evs if e["name"] == "train.step"] == [
        0, 1, 2]
    assert any(e["name"] == "train.ckpt_save" for e in evs)
    convs = [e for e in evs if e["name"] == "kernel.dispatch"]
    assert {e["args"]["site"] for e in convs} == {"conv1d"}
    assert {e["args"]["rung"] for e in convs} == {"plain"}
    snap = json.load(open(tmp_path / "metrics.json"))
    assert snap["histograms"]["train.step_s"][0]["count"] == 3
    rep = "\n".join(obs_report.render(tmp_path))
    assert "[train] steps=3 tokens=192 final-loss=" in rep
    assert "[train] step: p50=" in rep
