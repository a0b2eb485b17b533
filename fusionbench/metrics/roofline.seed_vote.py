"""roofline.seed_vote: the genome engines' seeding kernels
(csrc/seed_vote.cu ``seed_vote_warp_kernel`` and ``seed_vote_rows_kernel``)
against their roofline — the least time of the window's launches from the
work their inputs need (roofline.seed_vote_work: each byte read once at the
HBM rate, or the sort's comparisons at the int32 rate) over the kernels'
device time in the trace, in %.  The hook copies each launch's reads on
the card (their k-mers decide its work), one small copy a launch in the
traced window."""

from fusionbench import roofline

UNIT = "%"
KEY = "seed_vote"           # the arguments of each launch


def install(cap):
    """Record the arguments of every launch of the genome seeding."""
    from anchored_fusion_tpu_torch.ops import seed_vote_cuda
    launches = cap.data.setdefault(KEY, [])

    def vote(fn):
        def wrapped(flat, table, keys_sorted, pos, offsets, k, kb, stride,
                    max_hits, top_k, tile=None):
            launches.append(dict(
                flat=flat.clone(), table=table, keys_sorted=keys_sorted,
                offsets=offsets, k=k, kb=kb, stride=stride, H=max_hits,
                top_k=top_k, tile=tile is not None))
            return fn(flat, table, keys_sorted, pos, offsets, k, kb, stride,
                      max_hits, top_k, tile=tile)
        return wrapped

    cap.patch(seed_vote_cuda, "seed_vote_cuda", vote)


def read(ctx):
    tr = ctx["trace"]
    names = ("seed_vote_warp_kernel", "seed_vote_rows_kernel")
    bounds = [roofline.seed_vote_bound_s(roofline.seed_vote_work(**v))
              for v in ctx["cap"].data.get(KEY, [])]
    return roofline.share(bounds, tr.device_s(*names), tr.count(*names))
