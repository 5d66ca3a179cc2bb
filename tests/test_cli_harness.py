"""CLI driver, log round-trip, analyze_results aggregation, autotune."""

import sys
from pathlib import Path

import numpy as np
import pytest

from bsmr_sddmm import cli
from bsmr_sddmm.data import generate, io
from bsmr_sddmm.reorder.autotune import autotune, estimate_ms
from bsmr_sddmm.utils.logger import parse_log

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))


@pytest.fixture(scope="module")
def matrix_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("mats")
    csr = generate.block_clustered(12, 12, block_prob=0.25, seed=31)
    path = d / "demo.mtx"
    io.save_mtx(path, csr)
    return path


def test_cli_single_run(matrix_file, tmp_path, capsys):
    rc = cli.main(["-f", str(matrix_file), "-k", "32",
                   "-l", str(tmp_path), "--validate"])
    assert rc == 0
    out = capsys.readouterr().out
    entries = parse_log(out)
    assert entries["K"] == "32"
    assert float(entries["bsmr_gflops"]) > 0
    assert (tmp_path / "BSMR_k_32.log").exists()


def test_cli_positional_compat(matrix_file, capsys):
    # reference positional fallback: argv[1]=file argv[2]=K
    # (include/Options.hpp:120-123)
    rc = cli.main([str(matrix_file), "16"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "[K : 16]" in out
    # no file at all -> parser error
    with pytest.raises(SystemExit):
        cli.main([])


def test_cli_sweep_and_analyze(matrix_file, tmp_path):
    import analyze_results

    # tiny sweep: monkeypatch the grids for speed via direct calls
    rc = cli.main(["-f", str(matrix_file), "-k", "32",
                   "-l", str(tmp_path / "logs" / "demo")])
    assert rc == 0
    table = analyze_results.collect(tmp_path / "logs", 32)
    assert "demo" in table
    assert table["demo"]["bsmr"] > 0
    out_csv = tmp_path / "results_32.csv"
    analyze_results.write_csv(table, out_csv)
    text = out_csv.read_text()
    assert "matrix" in text and "demo" in text


def test_autotune_picks_valid_config():
    # sparse enough that the packed (non-dense) strategy wins the est
    csr = generate.block_clustered(48, 48, block_prob=0.03, seed=33)
    tuned = autotune(csr, k=64)
    assert tuned.est_ms > 0
    assert tuned.packed.nnz == csr.nnz
    # estimate is monotone-ish in work: a config with everything residual
    # must not be estimated faster than the tuned one
    from bsmr_sddmm.reorder.bsmr import BSMR
    from bsmr_sddmm.reorder.pack import pack
    worst = pack(csr, BSMR(0.3, 1.1, csr), merge_superpanels=False)
    assert estimate_ms(worst, 64) >= tuned.est_ms


def test_runlog_parse_roundtrip():
    from bsmr_sddmm.utils.logger import RunLog
    log = RunLog(input_file="x.mtx", k=128, alpha=0.3, delta=0.1,
                 sddmm_time_ms=2.0)
    log.m, log.n, log.nnz = 100, 100, 5000
    text = log.print_log()
    entries = parse_log(text)
    assert entries["bsmr_alpha"] == "0.3"
    assert float(entries["bsmr_sddmm"]) == 2.0
    expected_gflops = 2 * 5000 * 128 / (2.0 * 1e6)
    assert abs(float(entries["bsmr_gflops"]) - expected_gflops) < 1e-6


def test_scaling_bench_script_runs(capsys):
    import runpy
    import sys

    argv = sys.argv
    sys.argv = ["scaling_bench.py", "--devices", "1", "2",
                "--iterations", "2"]
    try:
        import pytest as _pytest
        with _pytest.raises(SystemExit):
            runpy.run_path("scripts/scaling_bench.py", run_name="__main__")
    finally:
        sys.argv = argv
    out = capsys.readouterr().out
    assert '"results"' in out
    # sharded fp32 may reassociate reductions; require the reference
    # tolerance class, not exact zero
    import json as _json
    json_line = [l for l in out.splitlines() if l.startswith("{")][-1]
    payload = _json.loads(json_line)
    assert all(r["max_rel_err"] < 1e-3 for r in payload["results"])


def test_run_baselines_script_runs(tmp_path, capsys):
    import runpy
    import sys

    from bsmr_sddmm.data import generate, io

    mdir = tmp_path / "m"
    mdir.mkdir()
    io.save_mtx(mdir / "tiny.mtx",
                generate.block_clustered(6, 6, block_prob=0.3, seed=3))
    argv = sys.argv
    sys.argv = ["run_baselines.py", str(mdir), str(tmp_path / "logs"),
                "--ks", "16", "--validate"]
    try:
        import pytest as _pytest
        with _pytest.raises(SystemExit):
            runpy.run_path("scripts/run_baselines.py", run_name="__main__")
    finally:
        sys.argv = argv
    logs = list((tmp_path / "logs").glob("*.log"))
    assert len(logs) == 1
    text = logs[0].read_text()
    assert "csr_check : PASS" in text
    assert "dense_check : PASS" in text
    assert "bsmr_check : PASS" in text


def test_hybrid_ablation_tools_and_csv(tmp_path, capsys):
    """bsmr_dense_only / bsmr_residual_only runs + the results_hybrid
    CSV (reference analyze_results.cpp:1127-1134 layout)."""
    import csv
    import runpy
    import sys

    from bsmr_sddmm.data import generate, io

    mdir = tmp_path / "m"
    mdir.mkdir()
    io.save_mtx(mdir / "tiny.mtx",
                generate.block_clustered(6, 6, block_prob=0.3, seed=3))
    argv = sys.argv
    sys.argv = ["run_baselines.py", str(mdir), str(tmp_path / "logs"),
                "--ks", "16", "--validate", "--tools", "bsmr",
                "bsmr_dense_only", "bsmr_residual_only"]
    try:
        import pytest as _pytest
        with _pytest.raises(SystemExit):
            runpy.run_path("scripts/run_baselines.py", run_name="__main__")
        text = next((tmp_path / "logs").glob("*.log")).read_text()
        assert "bsmr_dense_only_check : PASS" in text
        assert "bsmr_residual_only_check : PASS" in text
        sys.argv = ["analyze_results.py", str(tmp_path / "logs"),
                    "--k", "16", "--hybrid"]
        with _pytest.raises(SystemExit):
            runpy.run_path("scripts/analyze_results.py",
                           run_name="__main__")
    finally:
        sys.argv = argv
    hcsv = tmp_path / "logs" / "results_hybrid_16.csv"
    assert hcsv.exists()
    rows = list(csv.reader(hcsv.open()))
    assert rows[0] == ["matrix", "bsmr", "bsmr_dense_only",
                       "bsmr_residual_only"]
    assert len(rows) == 2


def test_fetch_suitesparse_mocked(tmp_path, monkeypatch, capsys):
    """Network path exercised with a mocked urlretrieve: URL layout,
    tarball extraction, cleanup (no egress in this environment)."""
    import importlib
    import sys as _sys
    import tarfile

    fetch = importlib.import_module("fetch_datasets")

    from bsmr_sddmm.data import generate, io

    def fake_retrieve(url, dest):
        assert url == "https://sparse.tamu.edu/MM/HB/tiny.tar.gz", url
        src = tmp_path / "tiny" / "tiny.mtx"
        src.parent.mkdir(exist_ok=True)
        io.save_mtx(src, generate.block_clustered(4, 4, block_prob=0.4,
                                                  seed=1))
        with tarfile.open(dest, "w:gz") as t:
            t.add(src, arcname="tiny/tiny.mtx")

    monkeypatch.setattr(fetch.urllib.request, "urlretrieve",
                        fake_retrieve)
    out = tmp_path / "got"
    fetch.fetch_suitesparse(["HB/tiny"], out)
    assert (out / "tiny" / "tiny.mtx").exists()
    assert not list(out.glob("*.tar.gz"))  # tarball cleaned up
    # malformed name is skipped with a message, not an exception
    fetch.fetch_suitesparse(["noslash"], out)
    assert "skip" in capsys.readouterr().err


def test_update_tuned_configs_tag_roundtrip():
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent
                           / "scripts"))
    from update_tuned_configs import parse_tag
    cfg = parse_tag("a=0.1 d=0.05 G=2 C=2 H=2048 apanels")
    assert cfg == {"alpha": 0.1, "delta": 0.05, "g": 2, "c": 2,
                   "merge": True, "hub": 2048, "a_layout": "panels"}
    cfg2 = parse_tag("a=0.3 d=0.0 G=1 C=1 H=0 legacy-carve")
    assert cfg2 == {"alpha": 0.3, "delta": 0.0, "g": 1, "c": 1,
                    "merge": True, "window_dp": False}
    cfg3 = parse_tag("a=0.3 d=0.0 G=4 C=1 H=0 apanels nomerge")
    assert cfg3 == {"alpha": 0.3, "delta": 0.0, "g": 4, "c": 1,
                    "merge": False, "a_layout": "panels"}


def test_r3_autofold_folds_and_arbitrates(tmp_path, monkeypatch):
    """End-to-end fold: probe winners land in tuned_configs.json, the
    dense-vs-hybrid dlmc decision uses the faster of the two hybrid
    sources, missing logs leave their entries untouched."""
    import json

    import r3_autofold as af
    import update_tuned_configs as utc

    results = tmp_path / "results"
    results.mkdir()
    configs = results / "tuned_configs.json"
    configs.write_text(json.dumps({
        "k128": {"clustered16": {"alpha": 0.3, "delta": 0.05, "g": 1,
                                 "c": 1, "merge": True},
                 "dlmc": {"alpha": 0.3, "delta": 0.05, "g": 1, "c": 1,
                          "merge": True}},
        "k32": {"clustered16": {"alpha": 0.3, "delta": 0.0, "g": 4,
                                "c": 1, "merge": False}},
    }))
    monkeypatch.setattr(af, "R", results)
    monkeypatch.setattr(utc, "CONFIGS", configs)

    (results / "probe_apanels_clustered16_r3.log").write_text(
        "winner: [a=0.3 d=0.05 G=1 C=1 H=0 apanels] 0.35 ms\n")
    (results / "probe_k32_apanels_r3.log").write_text(
        "winner: [a=0.3 d=0.0 G=4 C=1 H=0 apanels nomerge] 0.20 ms\n")
    # dense probe says dense 0.5 ms vs its own hybrid 1.2 ms, but the
    # interleaved dlmc shootout found a 0.45 ms hybrid -> hybrid stays
    (results / "probe_dense_dlmc_r3.log").write_text(
        "hybrid: nS=212 res=0 1.2000 ms  716 GFLOPS\n"
        "plain dot: 0.5000 ms  1718 GFLOPS\n")
    (results / "probe_dlmc_k128_r3.log").write_text(
        "winner: [a=0.3 d=0.0 G=1 C=1 H=0] 0.4500 ms\n")

    assert af.main([]) == 0
    data = json.loads(configs.read_text())
    assert data["k128"]["clustered16"] == {
        "alpha": 0.3, "delta": 0.05, "g": 1, "c": 1, "merge": True,
        "a_layout": "panels"}
    assert data["k32"]["clustered16"] == {
        "alpha": 0.3, "delta": 0.0, "g": 4, "c": 1, "merge": False,
        "a_layout": "panels"}
    # dlmc folded to the shootout winner, NOT displaced by dense
    assert data["k128"]["dlmc"]["delta"] == 0.0
    assert "dense" not in data["k128"]["dlmc"]

    # flip: no shootout log and dense beats the probe's hybrid -> dense
    (results / "probe_dlmc_k128_r3.log").unlink()
    assert af.main([]) == 0
    assert json.loads(configs.read_text())["k128"]["dlmc"] == {
        "dense": True}


def test_descriptor_floor():
    """The gather-engine floor is positive, below (or equal to) the full
    cost estimate, and the panels A-layout strictly reduces it."""
    from bsmr_sddmm.reorder.autotune import descriptor_floor_ms, from_params

    csr = generate.block_clustered(48, 48, block_prob=0.1,
                                   noise_density=5e-3, seed=37)
    cfg = from_params(csr, 128, alpha=0.3, delta=0.05)
    rows_f = descriptor_floor_ms(cfg.packed, 128)
    assert rows_f > 0
    assert rows_f <= estimate_ms(cfg.packed, 128) * 1.0001
    if cfg.packed.cont_panel_off is not None:
        pan_f = descriptor_floor_ms(cfg.packed, 128, a_layout="panels")
        assert pan_f < rows_f
    # more chunks -> more B descriptor issues
    assert descriptor_floor_ms(cfg.packed, 128, k_chunks=2) >= rows_f


@pytest.mark.parametrize("row_bytes", [128, 512, 1 << 20])
def test_take_ms_prices_every_row(row_bytes):
    """The gather term is the larger of rows / measured rate (the rate
    tables already hold repeated fetches) and the payload's write time,
    so it is linear in the row count."""
    from bsmr_sddmm.reorder import autotune as at

    src = 8e6
    one = at._take_ms(1e5, row_bytes, src)
    assert one == pytest.approx(1e3 * max(
        1e5 / at._row_rate(row_bytes, 8.0),
        1e5 * row_bytes / (at.STREAM_GBPS * 1e9)))
    assert at._take_ms(2e5, row_bytes, src) == pytest.approx(2 * one)
    assert at._take_ms(0, row_bytes, src) == 0.0


def test_descriptor_floor_reads_the_calibrated_tables():
    """Doubling every calibrated row rate halves the gather floor."""
    from bsmr_sddmm.reorder import autotune as at

    csr = generate.block_clustered(32, 32, block_prob=0.1,
                                   noise_density=5e-3, seed=38)
    cfg = at.from_params(csr, 64, alpha=0.3, delta=0.05)
    before = at.descriptor_floor_ms(cfg.packed, 64)
    saved = dict(at._ROW_RATE_8MB)
    try:
        at.load_calibration({"row_rate_8mb": {
            str(rb): 2 * r for rb, r in saved.items()}})
        assert at.descriptor_floor_ms(cfg.packed, 64) == \
            pytest.approx(before / 2)
    finally:
        at._ROW_RATE_8MB.update(saved)


def test_estimate_dense_ms_scales():
    from bsmr_sddmm.reorder.autotune import estimate_dense_ms
    small = estimate_dense_ms(256, 256, 64)
    big = estimate_dense_ms(1024, 1024, 64)
    assert 0 < small < big
    # K scaling: more FLOPs and more operand bytes, never faster
    assert estimate_dense_ms(1024, 1024, 256) >= big


def test_autotune_selects_dense_at_dlmc_density():
    """The true-DLMC density class (ops/dense.DenseSDDMM) must enter the
    candidate set and win the est-only ranking at pruned-ML densities."""
    csr = generate.random_sparse(96, 128, density=0.35, seed=5)
    tuned = autotune(csr, k=64, alphas=(0.3,), deltas=(0.0,),
                     merges=(False,))
    assert tuned.dense and tuned.packed is None
    # the selected strategy delivers correct values
    import numpy as np
    from bsmr_sddmm.ops.dense import DenseSDDMM
    from bsmr_sddmm.ops.reference import sddmm_reference
    from bsmr_sddmm.utils.check import check_values
    a = generate.make_dense(csr.m, 64, seed=1)
    b = generate.make_dense(64, csr.n, seed=2)
    runner = DenseSDDMM.from_csr(csr, compute_dtype="float32")
    res = check_values(sddmm_reference(a, b, csr),
                       np.asarray(runner(a, b=b, order="csr")))
    assert res.passed, str(res)


def test_autotune_keeps_packed_when_sparse():
    csr = generate.random_sparse(512, 512, density=0.002, seed=5)
    tuned = autotune(csr, k=64, alphas=(0.3,), deltas=(0.0,),
                     merges=(False,))
    assert not tuned.dense and tuned.packed is not None


def test_shootout_measures_dense_candidate():
    """measure=True with a dense finalist must time it via DenseSDDMM
    (no packed metadata) without touching the twin machinery."""
    csr = generate.random_sparse(64, 64, density=0.35, seed=7)
    tuned = autotune(csr, k=32, alphas=(0.3,), deltas=(0.0,),
                     merges=(False,), measure=True,
                     measure_iterations=2)
    assert tuned.measured_ms is not None and tuned.measured_ms >= 0.0


def test_cli_tune_flag_dense_and_hybrid(tmp_path):
    """--tune picks a strategy end-to-end; validate must pass for both a
    DLMC-density matrix (dense strategy) and a sparse one (hybrid)."""
    from bsmr_sddmm.data import io as dio
    from bsmr_sddmm.cli import main as cli_main

    dense_path = tmp_path / "dlmc.mtx"
    dio.save_mtx(dense_path, generate.random_sparse(96, 96, 0.3, seed=3))
    sparse_path = tmp_path / "sparse.mtx"
    dio.save_mtx(sparse_path,
                 generate.block_clustered(24, 24, block_prob=0.05,
                                          seed=4))
    for path in (dense_path, sparse_path):
        rc = cli_main(["-f", str(path), "-k", "32", "--tune",
                       "--validate", "-l", str(tmp_path / "logs")])
        assert rc == 0
