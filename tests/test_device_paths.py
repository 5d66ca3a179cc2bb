"""What surrounds the device code: the compile-cache directory, the
environment check, the dot each compute mode lowers to, the profiler
wrapper, the device record, and the entry points that must refuse to run
without a GPU (bench.py, chip_smoke.py)."""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench  # noqa: E402
import chip_smoke  # noqa: E402
from bsmr_sddmm.data import generate  # noqa: E402
from bsmr_sddmm.ops import hybrid  # noqa: E402
from bsmr_sddmm.utils import cache  # noqa: E402

BATCH_DN = (((2,), (2,)), ((0,), (0,)))


@pytest.fixture
def restore_cache_config():
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      saved[1])


def test_cache_off_on_cpu():
    assert cache.enable_persistent_cache() == ""


def test_cache_uses_env_dir_and_sets_nothing(monkeypatch, tmp_path,
                                             restore_cache_config):
    monkeypatch.setattr(cache, "_configured_platform", lambda: "gpu")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_persistent_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cache_defaults_to_repo_dir(monkeypatch, restore_cache_config):
    monkeypatch.setattr(cache, "_configured_platform", lambda: "gpu")
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert cache.enable_persistent_cache() == cache.DEFAULT_DIR
    assert jax.config.jax_compilation_cache_dir == cache.DEFAULT_DIR
    assert Path(cache.DEFAULT_DIR) == \
        Path(__file__).resolve().parent.parent / ".jax_cache"


def test_stale_environment_setting_raises():
    """A setting under the package's earlier variable names would be
    ignored silently; the import-time check names it and its new name."""
    from bsmr_sddmm import config
    old = "SDDMM_" + "X" + "_DEVICE_CLUSTER"
    with pytest.raises(RuntimeError, match="BSMR_SDDMM_DEVICE_CLUSTER"):
        config.check_environment({old: "0", "PATH": "/bin"})


def test_current_environment_settings_pass():
    from bsmr_sddmm import config
    config.check_environment({"BSMR_SDDMM_DEVICE_CLUSTER": "0",
                              "BSMR_SDDMM_PACK_TIMING": "1"})
    config.check_environment()   # the test process itself


@pytest.mark.parametrize("mode, marker", [
    # the card's TF32 class
    ("tf32", "precision = [HIGH, HIGH]"),
    ("float32", "precision = [HIGHEST, HIGHEST]"),
])
def test_mode_dot_in_lowered_hlo(mode, marker):
    """The tile dot of each fp32-storage mode carries its precision or
    algorithm into the lowered program (what XLA compiles on the card)."""
    a = jnp.ones((2, 16, 32), jnp.float32)
    b = jnp.ones((2, 128, 32), jnp.float32)
    text = jax.jit(lambda x, y: hybrid.tile_dot(x, y, BATCH_DN, mode)) \
        .lower(a, b).as_text()
    dots = [ln for ln in text.splitlines() if "dot_general" in ln]
    assert dots and all(marker in ln for ln in dots), dots


def test_split_modes_issue_bf16_dots():
    """float16 and mixed run as bf16 products with fp32 results."""
    a = jnp.ones((2, 16, 32), jnp.float16)
    b = jnp.ones((2, 128, 32), jnp.float16)
    text = jax.jit(lambda x, y: hybrid.tile_dot(x, y, BATCH_DN,
                                                "float16")) \
        .lower(a, b).as_text()
    dots = [ln for ln in text.splitlines() if "dot_general" in ln]
    assert len(dots) == 3
    assert all("bf16" in ln and "-> tensor<2x16x128xf32>" in ln
               for ln in dots), dots


def test_trace_raises_when_a_trace_cannot_start(tmp_path):
    from bsmr_sddmm.utils.profiling import trace
    with trace(tmp_path / "outer"):
        with pytest.raises(RuntimeError):
            with trace(tmp_path / "inner"):
                pass


def test_device_record_on_cpu():
    from bsmr_sddmm.utils.device import device_record
    rec = device_record()
    assert rec == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())}


def test_bench_refuses_to_measure_without_gpu(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["bench.py"])
    with pytest.raises(SystemExit, match="measures the GPU"):
        bench.main()


def test_chip_smoke_refuses_cpu(capsys):
    assert chip_smoke.main([]) == 1
    out = capsys.readouterr()
    assert out.out == ""
    assert "not a GPU" in out.err


def test_chip_smoke_result_line_format():
    line = chip_smoke.result_line({"platform": "gpu",
                                   "kind": "NVIDIA H100 80GB HBM3",
                                   "count": 1, "gpu": "x, 700.00 W"})
    assert json.loads(line) == {
        "ok": True, "device": {"platform": "gpu",
                               "kind": "NVIDIA H100 80GB HBM3",
                               "count": 1}}
    assert "\n" not in line


def test_four_card_check_on_virtual_devices():
    """The --four-cards comparison on four virtual CPU devices: the
    (2, 2) sharded run agrees with the one-device runner and with the
    float64 reference within the contract."""
    csr = generate.block_clustered(24, 24, block_prob=0.1,
                                   block_density=0.6, noise_density=0.002,
                                   seed=3)
    cfg = {"alpha": 0.3, "delta": 0.05, "a_layout": "panels"}
    r = chip_smoke.four_card_check(csr, 32, cfg, jax.devices()[:4])
    assert r["mesh"] == {"rows": 2, "feat": 2}
    assert r["four_vs_ref"].passed and r["one_vs_ref"].passed
    assert r["four_vs_one"].passed
    assert r["max_abs_diff"] < 1e-4


@pytest.mark.gpu
def test_committed_k128_cells_on_gpu(gpu_device):
    """On the card: every committed K=128 cell holds the contract in the
    default mode, packed and CSR order (chip_smoke.py runs all K)."""
    from bsmr_sddmm.ops.reference import sddmm_reference
    from bsmr_sddmm.utils.check import check_values
    for name, gen in bench.suite(quick=False).items():
        csr = gen()
        runner, tuned, _ = bench.build_runner(
            csr, 128, bench.load_tuned_config(name, 128))
        a = generate.make_dense(csr.m, 128, seed=1)
        b = generate.make_dense(128, csr.n, seed=2)
        got = np.asarray(runner(a, b=b, order="csr"))
        res = check_values(sddmm_reference(a, b, csr), got)
        assert res.passed, (name, str(res))
