"""The port's analysis gate (``repro_torch.analysis``) on the CPU: the launch
contracts' fixtures, the key space clean at the H100's 232,448 bytes, the
builders against every launcher and its query entry, the tuning hooks'
pruning, the lint, the bloat lint, the CLI and its report."""
import ast
import dataclasses
import json
import re
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import bloat, contracts, lint
from repro_torch.kernels import attention_decode as attn_dec
from repro_torch.kernels import autotune as tat
from repro_torch.kernels import gemm_plan
from repro_torch.kernels import sliding_conv1d as sc
from repro_torch.kernels import sliding_conv2d as s2
from repro_torch.kernels import sliding_conv_bwd as sb
from repro_torch.kernels import sliding_pool as spool

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
BUDGET = gemm_plan.SMEM_BLOCK


def _clean():
    return contracts.build_conv1d(B=1, L=16384, Cin=32, Cout=32, K=33)


def _kinds(inst, budget=BUDGET):
    return [v.kind for v in contracts.check_instance(inst, budget=budget)]


# ---------------------------------------------------------------------------
# a fixture per contract kind


def test_clean_fixture_passes():
    inst = _clean()
    # the split path is covered
    assert inst.splits > 1 and inst.workspace == inst.splits * inst.partial
    assert _kinds(inst) == []


def test_fixture_smem_budget():
    # a block over the budget cannot share an SM's bytes with another
    assert _kinds(dataclasses.replace(_clean(), smem=BUDGET + 1,
                                      per_sm=1)) == ["smem_budget",
                                                     "occupancy"]
    assert _kinds(_clean(), budget=1000) == ["smem_budget"]


def test_fixture_occupancy():
    # six blocks of 37,632 B fit the SM's 233,472 B; eight do not
    inst = _clean()
    assert inst.per_sm == 6 and _kinds(inst) == []
    assert _kinds(dataclasses.replace(inst, per_sm=8)) == ["occupancy"]


@pytest.mark.parametrize("grid,threads", [((1, 65536, 1), 64),
                                          ((1, 1, 65536), 64),
                                          ((2 ** 31, 1, 1), 64),
                                          ((1, 1, 1), 2048),
                                          ((0, 1, 1), 64)])
def test_fixture_grid_limit(grid, threads):
    inst = dataclasses.replace(_clean(), grid=grid, threads=threads)
    assert _kinds(inst) == ["grid_limit"]


# ---------------------------------------------------------------------------
# the key space


def test_check_all_families_clean():
    violations, stats = contracts.check_all(quick=True)
    assert violations == [], [v.line() for v in violations]
    assert stats["smem_budget"] == BUDGET and stats["instances"] > 500
    assert {f.split(".")[0] for f in stats["families"]} == set(
        contracts.FAMILIES)
    assert stats["smem_max"] <= BUDGET


def test_autotune_default_budget_prunes_nothing():
    for family, shape, cand in contracts.default_space(quick=True):
        assert contracts.check_autotune_candidate(family, shape,
                                                  cand) is None, cand


def test_default_space_holds_the_model_shapes():
    keys = {contracts.FAMILIES[f](**s, **c).key
            for f, s, c in contracts.default_space()}
    for want in ("conv1d|B4|L514|Cin80|Cout1024|K3|s1|bfloat16",
                 "conv1d|B4|L514|Cin1024|Cout1024|K3|s2|bfloat16",
                 "conv1ddw|B4|L259|C16384|K4|s1|bfloat16",
                 "conv1ddw|B2|L515|C16384|K4|s1|bfloat16|grad",
                 "conv2d|B20|H336|W336|Cin3|Cout1152|K14x14|s14x14|w8a8",
                 "attn_dec|B4|S3168|KV8|G7|D128|int8",
                 "attn_dec|B4|S288|KV1|G8|D256|bfloat16",
                 "attn_dec|B4|S288|KV4|G8|D128|int8",
                 "ssm|B4|L256|D16384|N16|bfloat16"):
        assert want in keys, want


def test_row11_over_budget_plan_flagged_and_refused():
    """rows 64, stages 4, f32, K 4: (63 + 4 + 64) · 128 · 4 · 4 bytes."""
    assert gemm_plan.depthwise_dw_smem(64, 4, 4, 4, 1) == 268_288
    shape = dict(B=2, L=515, C=16384, K=4, stride=1, dtype="float32")
    v = contracts.check_autotune_candidate(
        "conv1d_depthwise_bwd_dw", shape, dict(bwd_rows=64, bwd_stages=4))
    assert v is not None and v.kind == "smem_budget" and "268288" in v.detail
    with pytest.raises(gemm_plan.PlanError):
        gemm_plan.depthwise_dw_plan(2, 512, 16384, 4, 4, 1, rows=64,
                                    stages=4)
    # a refusal on other grounds is no verdict: the search meets it
    assert contracts.check_autotune_candidate(
        "conv1d_depthwise_bwd_dw", shape, dict(bwd_rows=6, bwd_stages=2)) \
        is None


def test_forward_depthwise_smem_is_the_plans():
    for rows in gemm_plan.DW_ROWS:
        for stages in (2, 3, 4):
            p = gemm_plan.depthwise_plan(4, 256, 16384, 2, 4, 1, rows=rows,
                                         stages=stages)
            assert p.smem == gemm_plan.depthwise_smem(rows, stages, 2, 4, 1)


def test_unknown_family_and_bad_candidate_give_none():
    assert contracts.check_autotune_candidate("nope", {}, {}) is None
    shape = dict(B=1, L=64, Cin=4, Cout=4, K=3)
    assert contracts.check_autotune_candidate("conv1d", shape,
                                              {"tile_l": 64}) is None
    assert contracts.check_autotune_candidate("conv1d", shape,
                                              {"tile": "mma"}) is None


# ---------------------------------------------------------------------------
# the builders, the launchers and their query entries


def _c_entries():
    """(library, symbol, int params, int* params) of every extern "C" int
    entry in csrc/*.cu."""
    out = []
    pat = re.compile(r'extern "C" int (\w+)\(([^)]*)\)', re.S)
    for src in sorted(CSRC.glob("*.cu")):
        for name, params in pat.findall(src.read_text()):
            ps = [p.strip() for p in params.split(",") if p.strip()]
            out.append((src.stem, name,
                        sum(1 for p in ps if re.match(r"int \w+$", p)),
                        sum(1 for p in ps if re.match(r"int\* \w+$", p))))
    return out


def test_builders_cover_every_launcher():
    launching = {(lib, sym) for lib, sym, _, _ in _c_entries()
                 if not sym.endswith("_query")}
    assert launching == set(contracts.LAUNCHERS)
    assert {f for f, _ in contracts.LAUNCHERS.values()} == set(
        contracts.FAMILIES)
    rows = {r for _, r in contracts.LAUNCHERS.values()}
    assert rows == {"1", "2, 2b", "3", "4", "5", "6", "7", "8", "9", "10",
                    "11", "12", "13", "14", "15", "16"}


def test_query_entries_match_the_instances():
    """Every instance's query names an entry of its library whose integer
    arguments it fills, then two int* outputs (smem, threads)."""
    entries = {(lib, sym): (n, np_) for lib, sym, n, np_ in _c_entries()}
    seen = set()
    for _, _, _, inst in contracts.instances(quick=True):
        lib, sym, *args = inst.query
        assert (lib, sym) in entries, (lib, sym)
        assert entries[(lib, sym)] == (len(args), 2), (sym, args)
        seen.add(sym)
    queries = {sym for _, sym, _, _ in _c_entries() if sym.endswith("_query")}
    assert seen == queries


def test_gemm_contract_matches_the_wrappers_launch():
    """The contract's plan, copy widths and workspace are the wrappers' own
    (``conv1d_launch``, ``product_launch``, ``dw_launch``) on tensors."""
    x = torch.zeros(1, 4096, 32)
    w = torch.zeros(33, 32, 32)
    for plan in (None, {"tile": "narrow", "splits": 2},
                 {"tile": "wide", "splits": 1}):
        p, va, vb, ws = sc.conv1d_launch(x, w, 1, 4096 - 32, plan)
        inst = contracts.build_conv1d(B=1, L=4096, Cin=32, Cout=32, K=33,
                                      **gemm_plan.forced(plan))
        assert inst.grid[2] == p.splits and inst.query[-1] == p.tile.id
        assert [c.width for c in inst.copies] == [va, vb]
        assert inst.workspace == (0 if ws is None else ws.numel())
    x2, w2 = torch.zeros(1, 40, 40, 8), torch.zeros(5, 5, 8, 16)
    p, va, vb, ws = s2.product_launch(x2, w2, (1, 1), 36, 36)
    inst = contracts.build_conv2d(B=1, H=40, W=40, Cin=8, Cout=16, kh=5,
                                  kw=5)
    assert (inst.grid[2], [c.width for c in inst.copies]) == (p.splits,
                                                              [va, vb])
    dz = torch.zeros(1, 36, 36, 16)
    p, va, vb, ws = sb.dw_launch(x2, dz, 5 * 5 * 8, 40, 8, 5, 1, True)
    inst = contracts.build_conv2d_bwd_dw(B=1, H=40, W=40, Cin=8, Cout=16,
                                         kh=5, kw=5)
    assert (inst.grid[2], [c.width for c in inst.copies]) == (p.splits,
                                                              [va, vb])
    assert inst.workspace == (0 if ws is None else ws.numel())


def test_depthwise_attention_pool_contracts_match_their_plans():
    x = torch.zeros(4, 259, 16384, dtype=torch.bfloat16)
    p, cb = sc.depthwise_launch(x, 4, 1, 256)
    inst = contracts.build_conv1d_depthwise(B=4, L=259, C=16384, K=4,
                                            dtype="bfloat16")
    assert (inst.grid[0], inst.smem, inst.per_sm) == (p.blocks, p.smem,
                                                      p.per_sm)
    assert inst.copies[0].width == cb
    dz = torch.zeros(2, 512, 16384, dtype=torch.bfloat16)
    x = torch.zeros(2, 515, 16384, dtype=torch.bfloat16)
    p, cb = sb.depthwise_dw_launch(x, dz, 4, 1)
    inst = contracts.build_conv1d_depthwise_bwd_dw(B=2, L=515, C=16384, K=4,
                                                   dtype="bfloat16")
    assert (inst.grid[0], inst.smem, inst.workspace) == (p.blocks, p.smem,
                                                         p.workspace)
    nsplit, rows = attn_dec.decode_splits(32, 3168)
    inst = contracts.build_attention_decode(B=4, S=3168, KV=8, G=7, D=128)
    assert inst.grid[:2] == (nsplit, 32) and inst.query[-2:] == (rows,
                                                                 nsplit)
    lay = spool.pool_layout(1, 16381, 32, 4, "max_scan", 4)
    inst = contracts.build_pool1d(B=1, L=16384, C=32, window=4)
    assert inst.smem == spool.pool_smem_bytes("max_scan", 4, lay.rows,
                                              lay.chans, lay.piece, 4)


def test_product_smem_transcribes_the_header():
    """smem_bytes<Tile, T, Gather> at the four tiles, both stagings."""
    assert contracts.product_smem("mma", 2, True) == 75_776
    assert contracts.product_smem("wide", 4, True) == 56_064
    assert contracts.product_smem("narrow", 4, True) == 37_632
    assert contracts.product_smem("int8", 1, True) == 81_920
    assert contracts.product_smem("wide", 4, False) == 50_688
    assert contracts.product_smem("mma", 2, False) == 69_632


def test_launcher_query_needs_a_built_library(monkeypatch):
    """On the CPU there is no nvcc: the query entry is reached only through
    ``build.entry``, which raises."""
    calls = []

    def entry(lib, sym, argtypes):
        calls.append((lib, sym, len(argtypes)))

        def fn(*args):
            args[-2]._obj.value, args[-1]._obj.value = 37_632, 64
            return 0
        return fn

    monkeypatch.setattr(contracts.build, "entry", entry)
    inst = _clean()
    assert contracts.launcher_query(inst) == (inst.smem, inst.threads)
    assert calls == [("sliding_conv1d", "sliding_conv1d_query", 4)]


# ---------------------------------------------------------------------------
# the tuning hooks: pruning


def test_autotune_prunes_over_budget_candidates(monkeypatch, capsys, caches):
    monkeypatch.setattr(contracts, "smem_budget", lambda: 40_000)
    monkeypatch.setattr(tat, "_time_fn", lambda fn, **_: (fn(), 1e-6)[1])
    shape = dict(B=1, L=16384, Cin=32, Cout=32, K=33, precision="fp",
                 dtype="float32")
    default, cands = tat.gemm_candidates(16352, 32, 33 * 32, torch.float32)
    ran = []
    res = tat._search("k", lambda c: ran.append(c), cands, default,
                      contract=tat._contract_checker("conv1d", shape))
    wide = [c for c in cands if c["tile"] == "wide"]
    assert wide and res.pruned == len(wide)
    assert not any(c["tile"] == "wide" for c in ran)
    assert "[autotune] pruned k" in capsys.readouterr().err
    assert res.timed == len(cands) - len(wide)


def test_autotune_never_prunes_default(monkeypatch, capsys, caches):
    monkeypatch.setattr(contracts, "smem_budget", lambda: 1_000)
    monkeypatch.setattr(tat, "_time_fn", lambda fn, **_: (fn(), 1e-6)[1])
    shape = dict(B=1, L=16384, Cin=32, Cout=32, K=33)
    default, cands = tat.gemm_candidates(16352, 32, 33 * 32, torch.float32)
    ran = []
    res = tat._search("k", lambda c: ran.append(c), cands, default,
                      contract=tat._contract_checker("conv1d", shape))
    assert ran[0] == default and res.timed == 1
    assert res.pruned == len([c for c in cands if c != default])


def test_plan_error_still_skips_untimed(monkeypatch, caches):
    monkeypatch.setattr(tat, "_time_fn", lambda fn, **_: (fn(), 1e-6)[1])

    def run(cfg):
        if cfg["splits"] == 3:
            raise gemm_plan.PlanError("refused")

    res = tat._search("k", run, [{"splits": 2}, {"splits": 3}],
                      {"splits": 1}, contract=lambda c: None)
    assert res.timed == 2 and res.pruned == 0


@pytest.fixture
def caches(tmp_path, monkeypatch):
    monkeypatch.setenv(tat.ENV_CACHE, str(tmp_path / "t.json"))
    tat.invalidate()
    yield tmp_path
    tat.invalidate()


# ---------------------------------------------------------------------------
# the lint


def test_lint_src_clean():
    violations, stats = lint.check_all()
    assert violations == [], [v.line() for v in violations]
    assert stats["files"] > 60


def _lint_src(tmp_path, text, name="m.py"):
    f = tmp_path / name
    f.write_text(text)
    return [v.kind for v in lint.lint_file(f, rel=f"repro_torch/{name}")]


def test_lint_flags_unknown_reason_literal(tmp_path):
    assert _lint_src(tmp_path, 'HEALTH.record("conv1d", "oops", "x")\n') == [
        "lint_reason"]


def test_lint_flags_fstring_reason(tmp_path):
    assert _lint_src(tmp_path,
                     'HEALTH.record("conv1d", f"r{x}", "x")\n') == [
        "lint_reason"]


def test_lint_flags_unregistered_site(tmp_path):
    assert _lint_src(tmp_path, 'f(site="whisper/conv9")\n') == ["lint_site"]
    assert _lint_src(tmp_path,
                     'HEALTH.record("convld", "jax_runtime", "x")\n') == [
        "lint_site"]


def test_lint_accepts_conv_site_pattern(tmp_path):
    assert _lint_src(tmp_path, 'f(site="conv1d|Cin80|Cout1024|K3")\n'
                               'f(site="whisper/conv1")\n') == []


def test_lint_flags_unknown_obs_names(tmp_path):
    assert _lint_src(tmp_path, 'reg.counter("autotune.nope")\n'
                               'span(f"x{y}")\n'
                               'reg.counter("autotune.pruned")\n'
                               'span("autotune.search")\n') == [
        "lint_obs_name", "lint_obs_name"]


def test_lint_flags_ladder_without_key(tmp_path):
    assert _lint_src(tmp_path, '_ladder("conv1d", a, b, operands=())\n'
                               '_ladder("conv1d", a, b, key=k)\n') == [
        "lint_ladder_key"]


def test_lint_flags_walltime_call(tmp_path):
    assert _lint_src(tmp_path, "import time\nt = time.time()\n") == [
        "lint_walltime"]


def test_lint_flags_from_time_import_time(tmp_path):
    assert _lint_src(tmp_path, "from time import time\n") == [
        "lint_walltime"]


def test_lint_walltime_allowlist_exempts_registered_files(tmp_path):
    d = tmp_path / "distributed"
    d.mkdir()
    f = d / "ft.py"
    f.write_text("import time\nt = time.time()\n")
    assert lint.lint_file(f, rel="repro_torch/distributed/ft.py") == []


def test_lint_walltime_ignores_perf_counter(tmp_path):
    assert _lint_src(tmp_path, "import time\nt = time.perf_counter()\n") == []


def test_lint_has_no_raw_indexing_rule():
    """The reference's pl.load rule has no counterpart: the port's kernels
    are CUDA sources, declared by the contracts."""
    src = (ROOT / "src" / "repro_torch" / "analysis" / "lint.py").read_text()
    assert "lint_raw_indexing" not in src.split('"""', 2)[2]


# ---------------------------------------------------------------------------
# the bloat lint and the chains


def test_fixture_im2col_bloat():
    for name, make in bloat.KNOWN_BLOATED.items():
        fn, shapes = make()
        v = bloat.check_fn(fn, shapes, family="bloat", key=name)
        assert v is not None and v.kind == "bloat", name


@pytest.mark.parametrize("name", sorted(bloat.GATE_RUNGS))
def test_sliding_rung_clean(name):
    fn, shapes = bloat.GATE_RUNGS[name]()
    assert bloat.check_fn(fn, shapes, family="bloat", key=name) is None


def test_bloat_alpha_argument(tmp_path):
    fn, shapes = bloat.KNOWN_BLOATED["conv1d.im2col_gemm"]()
    assert bloat.check_fn(fn, shapes, family="bloat", key="k",
                          alpha=100) is None
    violations, _ = bloat.check_bloat(alpha=100)
    assert {v.key for v in violations} == set(bloat.KNOWN_BLOATED)
    out = tmp_path / "a.json"
    assert cli.main(["--bloat", "--alpha", "100", "--json", str(out)]) == 1
    rep = json.loads(out.read_text())
    assert rep["stats"]["bloat"]["alpha"] == 100
    assert {v["key"] for v in rep["violations"]} == set(bloat.KNOWN_BLOATED)


def test_views_are_not_materialized():
    def fn(x, w):
        return x.permute(0, 2, 1)[:, :, 1:].unsqueeze(0).expand(4, -1, -1,
                                                               -1) * 1.0
    made, natural = bloat.materialized(fn, ((1, 64, 8), (3, 8, 8)))
    assert [op for _, op in made] == ["aten.mul.Tensor"]
    assert natural == 4 * 8 * 63 * 4


def test_dequant_chains_clean():
    violations, stats = bloat.check_chains()
    assert violations == [], [v.line() for v in violations]
    assert stats["chains"] == ["edge/c1 -> edge/c2 -> edge/c3",
                               "llava/patch_embed -> llava/projector",
                               "whisper/conv1 -> whisper/conv2"]


def test_chain_cycle_detected():
    violations, _ = bloat.check_chains({"a": "b", "b": "a"})
    assert [v.kind for v in violations] == ["chain_dequant"]
    violations, _ = bloat.check_chains({"h": "a", "a": "b", "b": "a"})
    assert any("cycle" in v.detail for v in violations)


# ---------------------------------------------------------------------------
# the CLI and its report


def test_cli_quick_run_writes_report(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("REPRO_TORCH_PEAKS", str(tmp_path / "none.json"))
    out = tmp_path / "a.json"
    rc = cli.main(["--all", "--quick", "--json", str(out), "--autotune-cache",
                   str(tmp_path / "none.json")])
    assert rc == 0
    rep = cli.load_report(str(out))
    assert rep["schema"] == 2 and rep["ok"] and rep["violations"] == []
    for section in ("contracts", "bloat", "lint", "costmodel", "ranges"):
        assert rep["stats"][section], section
    assert rep["stats"]["contracts"]["smem_budget"] == BUDGET
    assert all(d["pruned"] == 0 for d in
               rep["stats"]["contracts"]["autotune_prune"].values())
    assert "[analysis] OK" in capsys.readouterr().out


def test_cli_fails_on_violation(tmp_path, capsys):
    out = tmp_path / "a.json"
    rc = cli.main(["--contracts", "--quick", "--smem-budget", "1000",
                   "--json", str(out)])
    assert rc == 1
    rep = json.loads(out.read_text())
    assert not rep["ok"] and {v["kind"] for v in rep["violations"]} == {
        "smem_budget"}
    assert "FAIL" in capsys.readouterr().err


def test_load_report_reads_legacy_schema1(tmp_path):
    p = tmp_path / "old.json"
    p.write_text(json.dumps({"ok": True, "violations": [],
                             "stats": {"contracts": {"instances": 3}}}))
    rep = cli.load_report(str(p))
    assert rep["schema"] == 1 and rep["stats"]["costmodel"] == {}
    assert rep["stats"]["contracts"] == {"instances": 3}


def test_load_report_passthrough_schema2(tmp_path):
    p = tmp_path / "new.json"
    body = {"schema": 2, "ok": False, "violations": [{"kind": "x"}],
            "stats": {s: {"n": 1} for s in ("contracts", "bloat", "lint",
                                            "costmodel", "ranges")}}
    p.write_text(json.dumps(body))
    assert cli.load_report(str(p)) == body


def test_analysis_imports_neither_jax_nor_repro():
    for f in (ROOT / "src" / "repro_torch" / "analysis").glob("*.py"):
        tree = ast.parse(f.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "repro"), (f, n)
