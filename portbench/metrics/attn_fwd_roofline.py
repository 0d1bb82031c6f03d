"""The attention forward kernels' (K1 / K2, `csrc/flash_attn_fwd.cu`) share
of their roofline: the least time the chip could take for the attention
forward work of the window's videos (both towers, `counts.attention_work`)
over the device time of the kernels of that kind."""

from portbench import counts


def read(run):
    s = run.raw.get("summary")
    kernel_s = (s or {}).get("by_kind", {}).get("attention_fwd", 0.0)
    if not kernel_s:
        return None
    t = run.cell.traffic
    work = counts.attention_work(run.cfg, t["frames"], t["text_tokens"])
    least = sum(counts.roofline_s(w["flops"], w["bytes"]) for w in work.values())
    return 100.0 * run.raw["videos"] * least / kernel_s
