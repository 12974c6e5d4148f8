"""The dry-run's per-rank trace at full size: StableLM-1.6B's train_4k
on the 16 x 16 production mesh, where every width splits by 16 (32
heads, 32 KV heads, d_ff 5632, vocab 100,352, batch 256), so rank 0's
matmul FLOPs are exactly one 256th of the one-rank trace's.  Both are
fake-tensor traces (about 15 s and 30 s on this CPU)."""
from test_torch_dryrun_ranks import per_rank

from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun, steps


def test_stablelm_train_4k_per_rank_flops_are_a_256th_of_one_rank():
    cfg = get_config("stablelm-1.6b")
    shape = SHAPES["train_4k"]
    one = steps.build_plan(cfg, shape, dryrun.LOCAL_MESH).trace()
    cc, _, _ = per_rank(cfg, shape, "train", (16, 16))
    assert cc.costs().matmul_flops * 256 == one.costs().matmul_flops
