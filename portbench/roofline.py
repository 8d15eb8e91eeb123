"""The least time an H100 could take for the port's kernels.

Copied, with their arithmetic unchanged, from ``chip_smoke.py``
(``roofline``, ``interp_pass``, ``bound_upsample_argmax``, ``bound_ce``,
``PEAK_OPS_PER_S``) and ``tools/probe_copy.py`` (``PEAK_BYTES_PER_S``):
an H100 SXM by NVIDIA's data sheet, dense rates at the 700 W limit.
"""

from __future__ import annotations

#: operations/s by type: fp32 outside the tensor cores, bf16 and int8 on them
PEAK_OPS_PER_S = {"fp32": 67e12, "bf16_tensor": 989e12,
                  "int8_tensor": 1979e12}
#: device-memory bytes/s (HBM3)
PEAK_BYTES_PER_S = 3.35e12


def roofline(nbytes, ops):
    """(bound_ms, bound_by): the least time the card could take for work
    that moves ``nbytes`` (each input read once, each output written once)
    and does ``ops`` ({type: operations}, each at its peak rate): the
    larger of the two times."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_OPS_PER_S[k] for k, n in ops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def interp_pass(shape, out_hw):
    """Elements of the cheaper first pass of a separable align_corners
    upsample of (B, C, h, w) to ``out_hw``: rows interpolated at (B, C, h,
    W), or columns at (B, C, H, w)."""
    b, c, h, w = shape
    return b * c * min(h * out_hw[1], out_hw[0] * w)


def bound_upsample_argmax(shape, out_hw, elem):
    """Bound of one upsample_argmax call: it reads the (B, C, h, w) logits
    of ``elem`` bytes and six tap arrays and writes the (B, H, W) int32
    labels; the first pass of the interpolation (3 an element), then per
    output pixel and class the second pass (3) and a compare (fp32)."""
    b, c, h, w = shape
    px = b * out_hw[0] * out_hw[1]
    nbytes = b * c * h * w * elem + 12 * sum(out_hw) + 4 * px
    return roofline(nbytes, {"fp32": 3 * interp_pass(shape, out_hw)
                             + 4 * c * px})


def bound_ce(shape, out_hw, elem, n_valid, backward):
    """Bound of one fused CE call on ``n_valid`` labelled pixels. Both
    directions read the logits, the int32 labels and the taps; the forward
    writes the fp32 loss, the backward the gradient in the logits' dtype.
    The first pass of the interpolation costs 3 an element; per valid pixel
    and class the second pass (3) and max, subtract, exp, add (4); per
    valid pixel log, pick, subtract and sum (5). The backward adds, per
    valid pixel and class, divide, one-hot, scale (3) and the second pass's
    adjoint (4), and the first pass's adjoint (4 an element) (fp32)."""
    b, c, h, w = shape
    logits = b * c * h * w * elem
    nbytes = (logits + 4 * b * out_hw[0] * out_hw[1] + 12 * sum(out_hw)
              + (logits if backward else 4))
    first = interp_pass(shape, out_hw)
    ops = 3 * first + n_valid * (7 * c + 5)
    if backward:
        ops += n_valid * c * 7 + 4 * first
    return roofline(nbytes, {"fp32": ops})


def head_shapes(batch, hw, classes=19):
    """The (B, C, h, w) logits of BiSeNet's three heads (out, out16,
    out32: strides 8, 8 and 16) for (``batch``, 3, *``hw``) images."""
    h, w = hw
    return [(batch, classes, -(-h // 8), -(-w // 8))] * 2 + [
        (batch, classes, -(-h // 16), -(-w // 16))]


def ce_bound_ms(shapes, hw, n_valid, elem=2):
    """The bounds of the fused CE forward and backward over ``shapes``
    (one call each a head), summed, in ms."""
    return sum(bound_ce(s, hw, elem, n_valid, bwd)[0]
               for s in shapes for bwd in (False, True))
