"""The scoring step's share of the bf16 peak: videos per second of the traced
window times the model FLOPs of one video (`counts.video_flops`), over
989 TFLOP/s."""

from portbench import counts


def read(run):
    s = run.raw.get("summary")
    if not s:
        return None
    t = run.cell.traffic
    flops = counts.video_flops(run.cfg, t["frames"], t["text_tokens"])["total"]
    return 100.0 * run.raw["videos"] * flops / s["window_s"] / counts.PEAK_BF16_FLOPS
