"""Share of its roofline that the slice's pyramid work reaches: the least
bytes that building the frames' pyramids needs — each frame read once, and
every level's image, gx and gy written once — over the card's memory
rate, against the device time of the kernels that build them. The bytes
come from the configuration's shapes and the frames the slice ran, never
from the kernels; the kernels are named here, so that the same work is
counted whatever implements it."""

import json
from pathlib import Path

# kernels that build a frame's pyramid and its gradients (B1, B2)
KERNELS = ("pyramid_levels_kernel", "gradients_levels_kernel")
PEAKS = json.loads((Path(__file__).resolve().parents[1]
                    / "peaks.json").read_text())


def pyramid_bytes(height: int, width: int, levels: int) -> int:
    """Float32 bytes in and out of one frame's pyramid: the frame, then
    three planes (image, gx, gy) a level, each level halving the one above
    (rounding down)."""
    out, h, w = 0, height, width
    for _ in range(levels):
        out += 3 * h * w
        h, w = h // 2, w // 2
    return 4 * (height * width + out)


def read(ctx):
    s, frames = ctx.summary, ctx.layer.get("slice_frames")
    if s is None or not frames:
        return None
    t = s.device_s(KERNELS)
    if t <= 0:
        return None
    cam = ctx.cell.config["camera"]
    need = frames * pyramid_bytes(cam["height"], cam["width"],
                                  ctx.cell.config["svo"]["num_levels"])
    return 100.0 * need / PEAKS["hbm_bytes_per_s"] / t
