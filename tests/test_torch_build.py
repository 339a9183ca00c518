"""The kernel build layer without a compiler: an up-to-date library is
reused, a source change is seen, a missing nvcc is a clear error, and two
first launches at once build the library once."""
import threading
import time

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402


def test_up_to_date_library_is_reused(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    (tmp_path / "libkernels.so").write_bytes(b"")
    (tmp_path / "libkernels.sha256").write_text(_build.source_hash())
    monkeypatch.setattr(_build, "nvcc", lambda: pytest.fail("rebuilt"))
    info = _build.build()
    assert info == {"path": tmp_path / "libkernels.so", "built": False,
                    "seconds": 0.0}


def test_source_change_triggers_a_rebuild(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in _build.CSRC.iterdir():
        (csrc / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = _build.source_hash()
    assert before == _build.source_hash()
    (csrc / "epilogue.cuh").write_text("// changed\n")
    assert _build.source_hash() != before

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "build").mkdir()
    (tmp_path / "build" / "libkernels.so").write_bytes(b"")
    (tmp_path / "build" / "libkernels.sha256").write_text(before)

    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "nvcc", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_missing_nvcc_is_a_clear_error(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_every_source_is_built_and_every_entry_point_typed():
    assert sorted(_build.SOURCES) == sorted(
        p.name for p in _build.CSRC.glob("*.cu"))
    assert set(_build.SIGNATURES) == {
        "repro_conv2d_q8", "repro_depthwise2d_q8", "repro_maxpool2d_s8",
        "repro_shift_conv2d_q8", "repro_add_conv2d_q8", "repro_conv2d_w4",
        "repro_depthwise2d_w4", "repro_shift_conv2d_w4",
        "repro_add_conv2d_w4", "repro_matmul_q8", "repro_matmul_w4",
        "repro_causal_conv1d", "repro_conv2d_f", "repro_depthwise2d_f",
        "repro_maxpool2d_f", "repro_shift_conv2d_f", "repro_add_conv2d_f",
        "repro_matmul_f", "repro_conv2d_i8_plan", "repro_matmul_f_plan",
        "repro_shift_conv2d_i8_plan", "repro_shift_conv2d_f_plan",
        "repro_conv2d_f_plan", "repro_add_conv2d_f_plan",
        "repro_depthwise2d_plan", "repro_matmul_q8_plan",
        "repro_maxpool2d_s8_plan", "repro_maxpool2d_f_plan",
        "repro_causal_conv1d_plan"}
    # each entry point is defined in a source with as many parameters as
    # its ctypes signature declares
    import re
    src = "".join(p.read_text() for p in _build.CSRC.glob("*.cu"))
    for name, argtypes in _build.SIGNATURES.items():
        m = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
        assert m, name
        assert len(m.group(1).split(",")) == len(argtypes), name


def test_concurrent_first_builds_compile_once(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    compiles = []

    def fake_compile(lib):
        compiles.append(lib)
        time.sleep(0.2)                     # both callers are waiting now
        lib.write_bytes(b"lib")
    monkeypatch.setattr(_build, "_compile_and_link", fake_compile)
    results = []
    threads = [threading.Thread(target=lambda: results.append(_build.build()))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(compiles) == 1
    assert sorted(r["built"] for r in results) == [False, True]
    assert (tmp_path / "libkernels.sha256").read_text() == \
        _build.source_hash()
