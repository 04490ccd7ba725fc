"""The attention forward kernel's share of its roofline in the BigGAN step:
the least time its launches could take at their widths (24/96 for G's
block, 12/48 for D's; each launch's FLOPs over the bf16 peak or its bytes
over HBM bandwidth, whichever is larger, perfbench/work_biggan.py, over the
launches the program counted by width in the traced slice) over the device
time of the forward kernels, per step. None where the program counts no
launches by width."""

MOVES = "steps_per_s"
KERNELS = ("attention_fwd_mma_kernel",)


def read(run):
    if run.slice is None or not run.slice.units:
        return None
    roof = run.work.get("attn_fwd_roof_s_per_unit")
    seconds = sum(s for name, s in run.slice.kernel_s.items()
                  if any(k in name for k in KERNELS)) / run.slice.units
    if not roof or seconds <= 0:
        return None
    return 100.0 * roof / seconds
