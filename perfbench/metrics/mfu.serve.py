"""Share of the card's bf16 peak that G serving's images/s stands for: the
reference's FLOPs an image (perfbench/work.py) times the window's untraced
images/s."""

from perfbench import peaks

MOVES = "images_per_s"


def read(run):
    return 100.0 * run.work["flops_per_image"] * run.e2e["images_per_s"] / peaks.BF16_FLOPS
