"""The kernel build's cache key, on the CPU (no nvcc is run): a library
is rebuilt when its source or a local header it includes changes, and
reused otherwise."""
from repro_torch.kernels import build


def test_digest_follows_included_headers(tmp_path):
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\nint a();\n')
    (tmp_path / "b.cuh").write_text("int b();\n")
    (tmp_path / "other.cuh").write_text("int c();\n")
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "a.cuh"\n')
    first = build.digest(src)
    assert build.digest(src) == first
    (tmp_path / "other.cuh").write_text("int c2();\n")   # not included
    assert build.digest(src) == first
    (tmp_path / "b.cuh").write_text("int b2();\n")       # included by a.cuh
    second = build.digest(src)
    assert second != first
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\nint a2();\n')
    assert build.digest(src) not in (first, second)


def test_every_source_and_its_headers_are_in_the_checkout():
    """Each kernel source names the shared header it includes, and the
    library path carries the digest."""
    srcs = build.sources()
    assert set(srcs) == {"lamb", "lans", "paged_attention"}
    for name in ("lans", "lamb"):
        assert '#include "optim_common.cuh"' in srcs[name].read_text()
    for name, src in srcs.items():
        assert build._library_path(src).name == \
            f"{name}-{build.digest(src)}.so"
