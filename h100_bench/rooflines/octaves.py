"""The frame-batched extractor's octave layout, frozen: each octave's
(h, w) from the 2x-upsampled seed down, its padded plane (a ring of
PAD_DESC, rows and columns rounded up to 128, columns above 1536 up to
1024), and which octaves run the fused kernels (padded plane at least
256 x 256); the others run plain tensor ops."""

from __future__ import annotations

PAD_DESC = 56      # the largest descriptor radius, 39, plus 17


def padded_dims(h: int, w: int) -> tuple[int, int]:
    h_pad = -(-(h + 2 * PAD_DESC) // 128) * 128
    w_pad = -(-(w + 2 * PAD_DESC) // 128) * 128
    if w_pad > 1536:
        w_pad = -(-w_pad // 1024) * 1024
    return h_pad, w_pad


def fused_octaves(frame_h: int, frame_w: int, params):
    """[(octave, h, w, h_pad, w_pad)] of the fused octaves of a frame."""
    h, w = frame_h * params.inv_delta_min, frame_w * params.inv_delta_min
    out = []
    for o in range(params.n_octaves(h, w)):
        hp, wp = padded_dims(h, w)
        if hp >= 256 and wp >= 256:
            out.append((o, h, w, hp, wp))
        h, w = h // 2, w // 2
    return out
