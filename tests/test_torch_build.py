"""The kernel build helper, as far as a machine without nvcc can check it:
the library's name must change with every file under ``csrc/`` (a header that
is not hashed leaves a stale library in ``build/``), with the flags and with
the defines of a tool's own build."""

import shutil

import pytest

from nsgp_tpu_torch.ops import _build


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    dst = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, dst)
    monkeypatch.setattr(_build, "_CSRC", dst)
    return dst


def test_sources_are_every_cu_file_and_headers_are_not_compiled():
    names = {p.name for p in _build.SOURCES}
    assert names == {p.name for p in _build._CSRC.glob("*.cu")}
    assert {"fused_fwd_f32.cu", "fused_fwd_f64.cu", "fused_bwd_f32.cu",
            "fused_bwd_f64.cu", "fused_adf_f32.cu", "fused_adf_f64.cu", "fused_adf_mb_f32.cu",
            "fused_adf_mb_f64.cu", "adf_info.cu", "fused_ihgp_adf_f32.cu",
            "fused_ihgp_adf_f64.cu", "fused_ihgp_smooth_f32.cu", "fused_ihgp_smooth_f64.cu",
            "fused_adf_vjp_f32.cu", "fused_adf_vjp_f64.cu", "fused_ihgp_adf_vjp_f32.cu",
            "fused_ihgp_adf_vjp_f64.cu", "fused_resite_f32.cu", "fused_resite_f64.cu"} <= names
    assert not any(n.endswith(".cuh") for n in names)


@pytest.mark.parametrize("name", ["adf_step.cuh", "nsgp_common.cuh", "fused_adf.cuh",
                                  "fused_adf_mb.cuh", "fused_fwd_f32.cu", "adf_info.cu",
                                  "fused_kalman.cuh", "fused_bwd_f64.cu", "fused_ihgp_adf.cuh",
                                  "fused_ihgp_smooth.cuh", "fused_adf_vjp.cuh",
                                  "fused_adf_vjp_f32.cu", "fused_ihgp_adf_vjp.cuh",
                                  "fused_ihgp_adf_vjp_f64.cu", "fused_resite.cuh"])
def test_library_name_follows_every_file_under_csrc(csrc_copy, name):
    before = _build.library_path()
    with open(csrc_copy / name, "a") as f:
        f.write("\n// edited\n")
    assert _build.library_path() != before


def test_library_name_follows_new_files_and_defines(csrc_copy):
    before = _build.library_path()
    (csrc_copy / "new_piece.cuh").write_text("// a header no list names\n")
    assert _build.library_path() != before
    assert _build.library_path(defines=("-DNSGP_CLOCK_PROBE",)) != _build.library_path()
    probe = _build.library_path("libnsgp_probe", ("-DNSGP_CLOCK_PROBE",))
    assert probe.name.startswith("libnsgp_probe_") and probe.parent == _build.BUILD_DIR


def test_the_shipped_flags_carry_no_probe_and_no_fast_math():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "NSGP_CLOCK_PROBE" not in flags and "fast_math" not in flags
    assert "sm_90a" in flags
