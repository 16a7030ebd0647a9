"""The kernel build's library tags, on the CPU (no nvcc is run): a
library is rebuilt when its source, a shared header in ``csrc/`` or the
compiler flags change, and only then."""
from repro_torch.kernels import build


def _csrc(tmp_path):
    (tmp_path / "moe_gmm.cu").write_text('#include "hopper.cuh"\n')
    (tmp_path / "flash_attention.cu").write_text('#include "hopper.cuh"\n')
    (tmp_path / "hopper.cuh").write_text("// helpers v1\n")
    return tmp_path


def test_lib_path_changes_with_a_shared_header(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", _csrc(tmp_path))
    before = {n: build._lib_path(n) for n in ("moe_gmm", "flash_attention")}
    assert before == {n: build._lib_path(n) for n in before}   # stable
    (tmp_path / "hopper.cuh").write_text("// helpers v2\n")
    after = {n: build._lib_path(n) for n in before}
    for n in before:
        assert after[n] != before[n]
        assert after[n].parent == before[n].parent == build.BUILD_DIR
        assert after[n].name.startswith(f"lib{n}-")
    (tmp_path / "extra.cuh").write_text("// a new header\n")
    assert build._lib_path("moe_gmm") != after["moe_gmm"]


def test_lib_path_changes_with_the_source_and_the_flags(tmp_path,
                                                        monkeypatch):
    monkeypatch.setattr(build, "CSRC", _csrc(tmp_path))
    first = build._lib_path("moe_gmm")
    (tmp_path / "moe_gmm.cu").write_text('#include "hopper.cuh"\n// edit\n')
    second = build._lib_path("moe_gmm")
    assert second != first
    assert build._lib_path("flash_attention") != second
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ["-lineinfo"])
    assert build._lib_path("moe_gmm") != second


def test_split_compile_only_where_listed(tmp_path, monkeypatch):
    """``--split-compile`` goes to the sources of ``SPLIT_COMPILE`` alone,
    and is part of their libraries' tags."""
    assert build.SPLIT_COMPILE == ("paged_attention",)
    assert "--split-compile=0" in build._flags("paged_attention")
    for name in build.KERNELS:
        if name != "paged_attention":
            assert build._flags(name) == build.NVCC_FLAGS
    monkeypatch.setattr(build, "CSRC", _csrc(tmp_path))
    (tmp_path / "paged_attention.cu").write_text('#include "hopper.cuh"\n')
    split = build._lib_path("paged_attention")
    monkeypatch.setattr(build, "SPLIT_COMPILE", ())
    assert build._lib_path("paged_attention") != split


def test_every_kernel_has_its_source_and_a_tagged_library():
    """Each library of ``build.KERNELS`` (the schedule kernel among them)
    comes from its own ``csrc/<name>.cu`` and carries its name and tag."""
    assert "schedule" in build.KERNELS
    tags = set()
    for name in build.KERNELS:
        assert (build.CSRC / f"{name}.cu").is_file()
        path = build._lib_path(name)
        assert path.parent == build.BUILD_DIR
        assert path.name.startswith(f"lib{name}-") and path.suffix == ".so"
        tags.add(path.name)
    assert len(tags) == len(build.KERNELS)
