"""One rank of the gloo pool of tests/test_torch_distributed.py (2 ranks)
and tests/test_torch_tensor_distributed.py (4 ranks):

    python tests/_torch_dist_worker.py RANK WORLD PORT WORKDIR

joins the group at tcp://localhost:PORT, runs every case of
`tests/_torch_dist_cases.py` that `WORKDIR/plan.json` lists, and on rank 0
writes each result to `WORKDIR/<case>.pt` (or the error to
`WORKDIR/<case>.err`). A failing case does not stop the others."""

import json
import os
import sys
import traceback

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tests import _torch_dist_cases as cases  # noqa: E402


def run(name, spec, workdir):
    kind = spec["kind"]
    out_dir = os.path.join(workdir, f"out_{name}_r{dist.get_rank()}")
    layout = tuple(spec["layout"]) if spec.get("layout") else None
    if kind == "train":
        res = cases.train_case(spec["stage"], layout, spec.get("accum", 1), out_dir=out_dir)
    elif kind == "save":
        res = {"next_loss": cases.save_after_one_step(spec["ckpt"], tuple(spec["layout"]),
                                                      out_dir=out_dir)}
    elif kind == "resume":
        step, loss = cases.resume_and_step(spec["ckpt"], tuple(spec["layout"]), out_dir=out_dir)
        res = {"step": step, "next_loss": loss}
    elif kind == "inference":
        got = cases.inference_case(shard=True, eos=spec["eos"], layout=layout)
        res = {k: cases.gather_rows(v, cases.tensor_size(layout)) for k, v in got.items()}
    elif kind == "cli_stage1":
        from aigv_assessor_torch.cli import stage1_train

        stage1_train.main(spec["argv"])
        res = {}
    else:
        raise ValueError(kind)
    return res


def main():
    rank, world, port, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    with open(os.path.join(workdir, "plan.json")) as f:
        plan = json.load(f)
    for name, spec in plan.items():
        try:
            res = run(name, spec, workdir)
            if rank == 0:
                torch.save(res, os.path.join(workdir, f"{name}.pt"))
        except Exception:
            with open(os.path.join(workdir, f"{name}.err.r{rank}"), "w") as f:
                f.write(traceback.format_exc())
            # a rank that failed mid-case may leave the other waiting in a
            # collective: stop here rather than run into a mismatched one
            raise
        dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
