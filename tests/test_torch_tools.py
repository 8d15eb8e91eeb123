"""The port's copy probe and roll against the JAX ``tools/`` kernels, on the CPU.

The three ``tools/`` scripts that reach ``pl.pallas_call`` are loaded by
path (``tools/`` is no package) and their kernel bodies run through
``pl.pallas_call`` in interpret mode: ``_bounce_kernel`` (2 slots of 128
rows, 8 of 64) and ``_hbm2hbm_kernel`` of ``probe_dma_manual.py`` with
``pltpu.InterpretParams()``, ``copy_kernel`` of ``probe_pallas_dma.py`` on
its row grid and the roll ``_kernel`` of ``mosaic_roll_repro.py`` with
``interpret=True``. Their module-level ``ROWS``/``COLS`` are set on the
loaded module objects, at a small size. The port's wrappers run their
plain versions here (a CPU tensor); every comparison is bit for bit. The
CUDA kernels themselves run only on a card (tests/test_torch_cuda.py,
chip_smoke.py). Both entry points run as a user runs them, with
``--device cpu``.
"""

import functools
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from dasemanticsegmentationaml_tpu_torch.ops.cuda import copy_probe as cp
from dasemanticsegmentationaml_tpu_torch.ops.cuda import tile_roll as tr
from dasemanticsegmentationaml_tpu_torch.tools import probe_copy, roll_repro

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS, COLS = 1024, 256


def _load_tool(name):
    path = os.path.join(REPO, "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def dma_manual():
    module = _load_tool("probe_dma_manual")
    module.ROWS, module.COLS = ROWS, COLS
    return module


@pytest.fixture(scope="module")
def pallas_dma():
    module = _load_tool("probe_pallas_dma")
    module.ROWS, module.COLS = ROWS, COLS
    return module


@pytest.fixture(scope="module")
def roll_repro_jax():
    return _load_tool("mosaic_roll_repro")


#: ``jnp.roll`` compiled once per shape and dtype, the shift traced
_jnp_roll = jax.jit(jnp.roll, static_argnames="axis")


def _bf16_pair(seed=0, shape=(ROWS, COLS)):
    """The same seeded bf16 values for both sides."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return (jnp.asarray(x, jnp.bfloat16),
            torch.from_numpy(x).to(torch.bfloat16))


def _bits(a):
    """Bit patterns of a JAX array or a torch tensor, as numpy."""
    if isinstance(a, torch.Tensor):
        return a.view({2: torch.int16, 4: torch.int32}[a.element_size()]).numpy()
    a = np.asarray(a)
    return a.view({2: np.int16, 4: np.int32}[a.dtype.itemsize])


def _jax_manual_copy(kernel, x):
    """probe_dma_manual.py::_call's pallas_call, in interpret mode."""
    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((ROWS, COLS), jnp.bfloat16),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec(memory_space=pl.ANY),
        interpret=pltpu.InterpretParams())(x)


def _jax_block_copy(module, x):
    """probe_pallas_dma.py::pallas_copy's row grid, in interpret mode."""
    spec = pl.BlockSpec((module.BLK, COLS), lambda i: (i, 0))
    return pl.pallas_call(
        module.copy_kernel,
        out_shape=jax.ShapeDtypeStruct((ROWS, COLS), jnp.bfloat16),
        grid=(ROWS // module.BLK,), in_specs=[spec], out_specs=spec,
        interpret=True)(x)


@pytest.mark.parametrize("variant", ["bounce2", "bounce8", "hbm2hbm",
                                     "block"])
def test_copy_matches_jax_probe_kernel(variant, dma_manual, pallas_dma):
    """Each port copy against the TPU kernel it replaces: copy_bounce at 2
    and 8 slots against ``_bounce_kernel(2, 128)`` / ``(8, 64)``,
    copy_direct against ``_hbm2hbm_kernel``, copy_block against
    ``copy_kernel``; into a new tensor and into ``out``."""
    xj, xt = _bf16_pair(seed=len(variant))
    if variant == "block":
        want = _jax_block_copy(pallas_dma, xj)
        port = cp.copy_block
    elif variant == "hbm2hbm":
        want = _jax_manual_copy(dma_manual._hbm2hbm_kernel, xj)
        port = cp.copy_direct
    else:
        n_slots, blk = {"bounce2": (2, 128), "bounce8": (8, 64)}[variant]
        want = _jax_manual_copy(
            functools.partial(dma_manual._bounce_kernel, n_slots, blk), xj)
        port = functools.partial(cp.copy_bounce, n_slots=n_slots)
    assert np.array_equal(_bits(want), _bits(xt))
    out = torch.empty_like(xt)
    for got in (port(xt), port(xt, out)):
        assert got.dtype == torch.bfloat16 and got.shape == xt.shape
        assert np.array_equal(_bits(got), _bits(want))
    assert got is out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int16", "int32"])
def test_roll_matches_jax_roll_kernel(dtype, roll_repro_jax):
    """tile_roll at shift 1 on the repro's (8, 128) tile against its
    ``_kernel`` (``pltpu.roll(x, 1, 1)``) in interpret mode."""
    base = np.random.default_rng(3).integers(-3000, 3000, (8, 128))
    xj = jnp.asarray(base.astype(np.float32)).astype(dtype)
    want = pl.pallas_call(
        roll_repro_jax._kernel,
        out_shape=jax.ShapeDtypeStruct(xj.shape, xj.dtype),
        interpret=True)(xj)
    xt = torch.from_numpy(base.astype(np.float32)).to(getattr(torch, dtype))
    got = tr.tile_roll(xt, 1)
    assert got.dtype == xt.dtype and got.shape == (8, 128)
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("cols", [64, 128, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int16", "int32"])
def test_roll_matches_jnp_roll(dtype, cols):
    """Every shift of the edge set, wrap-arounds and negative shifts
    included, on one and eight rows, against ``jnp.roll``."""
    for rows in (1, 8):
        base = np.random.default_rng(cols + rows).integers(-3000, 3000,
                                                           (rows, cols))
        xj = jnp.asarray(base.astype(np.float32)).astype(dtype)
        xt = torch.from_numpy(base.astype(np.float32)).to(getattr(torch, dtype))
        for shift in (0, 1, -1, 63, 127, 128, 129, -300):
            want = _jnp_roll(xj, shift, axis=1)
            assert np.array_equal(_bits(tr.tile_roll(xt, shift)), _bits(want))


def test_copy_wrappers_reject_what_the_kernels_do_not_take():
    """The same inputs raise on the CPU as on a card: the plain version is
    no wider than the kernels."""
    x = torch.zeros(64, dtype=torch.bfloat16)
    for fn in (cp.copy_block, cp.copy_direct, cp.copy_bounce):
        with pytest.raises(ValueError):        # 14 bytes
            fn(x[:7])
        with pytest.raises(ValueError):        # 2 bytes off a boundary
            fn(x[1:9])
        with pytest.raises(ValueError):
            fn(x.view(8, 8).t())
        with pytest.raises(ValueError):        # out overlaps x
            fn(x[:32], x[8:40])
        with pytest.raises(ValueError):        # out of another dtype
            fn(x, torch.zeros(64))
        with pytest.raises(TypeError):
            fn(torch.zeros(16, dtype=torch.bool))
    assert not cp.ring_fits(4, 16 * 1024)
    assert not cp.ring_fits(8, 32 * 1024)    # over 227 KB with the barriers
    assert not cp.ring_fits(2, 1000)         # not a multiple of 16 bytes
    assert cp.ring_fits(2, 112 * 1024) and cp.ring_fits(8, 28 * 1024)
    # stores left unread: 1 .. n_slots - 1
    assert not cp.ring_fits(8, 16 * 1024, stores=0)
    assert not cp.ring_fits(8, 16 * 1024, stores=8)
    assert not cp.ring_fits(2, 16 * 1024, stores=2)
    assert cp.ring_fits(8, 16 * 1024, stores=7)
    # two rings and their system share in one SM's 228 KB
    assert not cp.ring_fits(8, 16 * 1024, blocks_per_sm=2)
    assert not cp.ring_fits(2, 112 * 1024, blocks_per_sm=2)
    assert cp.ring_fits(8, 12 * 1024, 7, 2) and cp.ring_fits(2, 56 * 1024, 1, 2)
    assert not cp.ring_fits(2, 16 * 1024, blocks_per_sm=3)
    with pytest.raises(ValueError):
        cp.copy_bounce(x, n_slots=4)
    with pytest.raises(ValueError):
        cp.copy_bounce(x, n_slots=2, stores=2)
    with pytest.raises(ValueError):
        cp.copy_bounce(x, n_slots=8, chunk_bytes=16 * 1024, blocks_per_sm=2)
    with pytest.raises(ValueError):
        cp.copy_direct(x, tiles_per_block=-1)
    # every ring the probe sweeps is taken, and each depth's default
    for n_slots in cp.SLOTS:
        for ring in [cp.BOUNCE_DEFAULTS[n_slots], *probe_copy.rings(n_slots)]:
            assert cp.ring_fits(n_slots, ring.chunk_bytes, ring.stores,
                                ring.blocks_per_sm)
        assert ({r.stores for r in probe_copy.rings(n_slots)}
                == set(range(1, n_slots)))


#: 16-byte vectors: one, fewer than a tile, whole tiles and a ragged tail,
#: and the probe's 256 MB
_GEOMETRY_SIZES = [1, 1000, 5 * cp.DIRECT_TILE + 17,
                   16384 * 8192 * 2 // 16]


@pytest.mark.parametrize("sms", [1, 7, 132])
@pytest.mark.parametrize("n16", _GEOMETRY_SIZES)
def test_direct_geometry_covers_every_vector_once(n16, sms):
    """copy_direct's split, at every span length the probe sweeps:
    contiguous spans of whole tiles (the last cut at the end), in block
    order, covering every vector exactly once, no block more than one tile
    above another, and a grid of about ``tiles_per_block`` tiles a block but
    at least the resident blocks (or every tile), or exactly those."""
    tiles = -(-n16 // cp.DIRECT_TILE)
    resident = min(tiles, sms * cp.DIRECT_RESIDENT)
    for tiles_per_block in probe_copy.DIRECT_TILES + (3, 8):
        geo = cp.direct_geometry(n16, sms, tiles_per_block)
        if tiles_per_block:
            assert geo.grid == max(-(-tiles // tiles_per_block), resident)
        else:
            assert geo.grid == resident
        spans = geo.spans()
        assert len(spans) == geo.grid
        covered = np.zeros(n16, np.int32)
        for start, stop in spans:
            assert start % cp.DIRECT_TILE == 0 and start < stop
            covered[start:stop] += 1
        assert (covered == 1).all()
        assert [s[0] for s in spans[1:]] == [s[1] for s in spans[:-1]]
        assert spans[0][0] == 0 and spans[-1][1] == n16
        counts = [-(-(stop - start) // cp.DIRECT_TILE)
                  for start, stop in spans]
        assert sum(counts) == tiles and max(counts) - min(counts) <= 1
        assert counts == [geo.base + (b < geo.extra)
                          for b in range(geo.grid)]
    assert cp.direct_geometry(0, sms).grid == 0


def test_roll_rejects_what_the_kernel_does_not_take():
    """Rows off 16 bytes and tensors off a 16-byte boundary raise on the
    CPU as on a card: the plain version is no wider than the kernel."""
    with pytest.raises(ValueError):            # 14-byte rows
        tr.tile_roll(torch.zeros(2, 7, dtype=torch.int16), 1)
    with pytest.raises(ValueError):            # 28-byte rows of a 32-bit type
        tr.tile_roll(torch.arange(21, dtype=torch.int32).view(3, 7), 9)
    with pytest.raises(ValueError):            # 2 bytes off a boundary
        tr.tile_roll(torch.zeros(33, dtype=torch.bfloat16)[1:].view(2, 16), 1)
    with pytest.raises(ValueError):            # 4 bytes off a boundary
        tr.tile_roll(torch.zeros(36)[1:33].view(2, 16), 1)
    with pytest.raises(TypeError):
        tr.tile_roll(torch.zeros(2, 8, dtype=torch.float64), 1)
    with pytest.raises(ValueError):
        tr.tile_roll(torch.zeros(2, 8, 8), 1)
    with pytest.raises(ValueError):
        tr.tile_roll(torch.zeros(2, 8).t(), 1)
    # a row of one 16-byte vector is taken
    x = torch.arange(12, dtype=torch.int32).view(3, 4)
    assert torch.equal(tr.tile_roll(x, 9), torch.roll(x, 9, 1))


def _run_module(name, *args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run(
        [sys.executable, "-m", f"dasemanticsegmentationaml_tpu_torch.tools.{name}",
         *args], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=120)


def test_probe_copy_entry_point_on_cpu():
    proc = _run_module("probe_copy", "--device", "cpu", "--rows", "64",
                       "--cols", "256")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("probe_copy: 64 x 256 bf16 (32768 bytes) on "
                               "cpu")
    labels = [line.split(":")[0] for line in lines[1:-3]]
    assert labels == [label for label, _ in probe_copy.variants()]
    assert labels[:5] == ["copy_block", "copy_direct tiles_per_block=1",
                          "copy_direct tiles_per_block=2",
                          "copy_direct tiles_per_block=4",
                          "copy_direct tiles_per_block=persistent"]
    assert probe_copy.direct_label() in labels
    # the ring's sweep: one store unread (stores=1) to the TPU's (stores=7)
    for n_slots in cp.SLOTS:
        assert probe_copy.bounce_label(n_slots) in labels
    assert ("copy_bounce n_slots=8 stores=1 chunk=16 KB blocks_per_sm=1 "
            "dynamic=0") in labels
    assert ("copy_bounce n_slots=8 stores=7 chunk=4 KB blocks_per_sm=2 "
            "dynamic=1") in labels
    for line in lines[1:-3]:
        assert "GB/s" in line and "output bit-identical" in line
        assert "of 3.35 TB/s" not in line   # no device figure from the CPU
    assert [line.split(":")[0] for line in lines[-3:]] == [
        "fastest copy_direct", "fastest copy_bounce n_slots=2",
        "fastest copy_bounce n_slots=8"]


def test_probe_copy_without_a_card_exits_non_zero():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        probe_copy.main(["--rows", "8", "--cols", "8"])


def test_roll_repro_entry_point_on_cpu(capsys):
    proc = _run_module("roll_repro", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.splitlines() == ["float32: ok", "bfloat16: ok",
                                        "int16: ok", "int32: ok"]
    # 16-bit rows of 60 values (120 bytes) raise, after float32 has passed
    with pytest.raises(ValueError, match="multiple of 16 bytes"):
        roll_repro.main(["--device", "cpu", "--cols", "60"])
    assert capsys.readouterr().out.splitlines() == ["float32: ok"]


@pytest.mark.parametrize("name", ["copy_probe", "fused_stdc"])
def test_ring_helpers_live_in_one_header(name, tmp_path):
    """The TMA ring's helpers are defined once, in csrc/tma_ring.cuh, which
    both kernels that stream by bulk copies include; an edit of the
    header rebuilds each of them (its digest changes)."""
    import re
    import shutil

    from dasemanticsegmentationaml_tpu_torch.ops.cuda import build

    src = os.path.join(build.CSRC_DIR, f"{name}.cu")
    with open(src) as f:
        text = f.read()
    assert '#include "tma_ring.cuh"' in text
    for helper in ("mbar_init", "mbar_expect_tx", "mbar_wait", "bulk_load",
                   "bulk_store", "smem_addr"):
        assert not re.search(rf"__device__[^;{{]*\b{helper}\(", text), helper
    shutil.copy(src, tmp_path / f"{name}.cu")
    shutil.copy(os.path.join(build.CSRC_DIR, "tma_ring.cuh"), tmp_path)
    first = build.source_digest(str(tmp_path / f"{name}.cu"))
    with open(tmp_path / "tma_ring.cuh", "a") as f:
        f.write("// edited\n")
    assert build.source_digest(str(tmp_path / f"{name}.cu")) != first
