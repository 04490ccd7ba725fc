"""The attention backward kernels' share of their roofline in the BigGAN
step: the least time the backward's launches could take at their widths
(2 Q K (3 Ca + 2 Cv) FLOPs over the bf16 peak, or each operand and gradient
moved once over HBM bandwidth, whichever is larger, perfbench/work_biggan.py,
over the launches the program counted by width in the traced slice) over
the device time of the backward's kernels (statistics, gradients,
reduction), per step. None where the program counts no launches by width."""

MOVES = "steps_per_s"
KERNELS = ("attention_bwd_",)


def read(run):
    if run.slice is None or not run.slice.units:
        return None
    roof = run.work.get("attn_bwd_roof_s_per_unit")
    seconds = sum(s for name, s in run.slice.kernel_s.items()
                  if any(k in name for k in KERNELS)) / run.slice.units
    if not roof or seconds <= 0:
        return None
    return 100.0 * roof / seconds
