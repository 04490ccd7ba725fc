"""The attention forward kernel's share of its roofline in G serving: the
least time the core could take (its FLOPs over the bf16 peak or its bytes
over HBM bandwidth, whichever is larger, perfbench/work.py) over the device
time of the kernels named here, per forward of the traced slice. No
exponential-unit roof: a polynomial exp2 could beat it."""

from perfbench import peaks

MOVES = "images_per_s"
KERNELS = ("attention_fwd_mma_kernel", "fused_block_fwd_mma_kernel")


def read(run):
    if run.slice is None or not run.slice.units:
        return None
    seconds = sum(s for name, s in run.slice.kernel_s.items()
                  if any(k in name for k in KERNELS)) / run.slice.units
    if seconds <= 0:
        return None
    roof = max(run.work["attn_flops_per_unit"] / peaks.BF16_FLOPS,
               run.work["attn_bytes_per_unit"] / peaks.HBM_BYTES)
    return 100.0 * roof / seconds
