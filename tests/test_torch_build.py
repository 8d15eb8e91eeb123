"""The kernel builder's cache key, on the CPU (no nvcc needed)."""

import hashlib

from dasemanticsegmentationaml_tpu_torch.ops.cuda import build


def test_digest_sees_the_headers_a_source_includes(tmp_path):
    """Editing a local header, or one it includes, changes the digest of
    the source that includes it, so a stale library is never loaded;
    system headers and other files do not count."""
    src = tmp_path / "k.cu"
    src.write_text('#include <cuda_runtime.h>\n#include "ring.cuh"\n'
                   'int main() { return 0; }\n')
    (tmp_path / "ring.cuh").write_text('#pragma once\n#include "sub.cuh"\n')
    (tmp_path / "sub.cuh").write_text("// v1\n")
    (tmp_path / "other.cuh").write_text("// unused\n")
    first = build.source_digest(str(src))
    assert len(first) == 16 and first == build.source_digest(str(src))
    (tmp_path / "other.cuh").write_text("// changed\n")
    assert build.source_digest(str(src)) == first
    (tmp_path / "sub.cuh").write_text("// v2\n")
    second = build.source_digest(str(src))
    assert second != first
    (tmp_path / "ring.cuh").write_text('#pragma once\n#include "sub.cuh"\n'
                                       "// edited\n")
    assert build.source_digest(str(src)) not in (first, second)


def test_digest_of_a_source_without_headers_is_unchanged(tmp_path):
    """A source that includes no local header keeps the key it had: the
    hash of its text and the flags."""
    src = tmp_path / "k.cu"
    src.write_bytes(b"__global__ void k() {}\n")
    want = hashlib.sha256(src.read_bytes() + " ".join(
        build.NVCC_FLAGS).encode()).hexdigest()[:16]
    assert build.source_digest(str(src)) == want
