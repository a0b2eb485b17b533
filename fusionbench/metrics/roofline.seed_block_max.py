"""roofline.seed_block_max: the anchored seeding kernel
(csrc/anchor.cu ``seed_block_max_kernel``, block-max and top-k modes)
against its roofline — the least time of the window's launches at the
shapes captured around them (roofline.seed_block_bound_s: 2·M·Rs·4·D int8
operations at the int8 peak, or the bytes at the HBM rate) over the
kernel's device time in the trace, in %."""

from fusionbench import roofline

UNIT = "%"
KEY = "seed_block_max"      # (M, R, Rs, D, k) of each launch


def install(cap):
    """Record the shape of every launch of the anchored seeding."""
    from anchored_fusion_tpu_torch.ops import anchor_cuda
    shapes = cap.data.setdefault(KEY, [])

    def block_max(fn):
        def wrapped(flat, seed, stride=1):
            shapes.append((flat.shape[0], flat.shape[1], seed.positions,
                           seed.diagonals, 0))
            return fn(flat, seed, stride)
        return wrapped

    def topk(fn):
        def wrapped(flat, seed, stride, k):
            shapes.append((flat.shape[0], flat.shape[1], seed.positions,
                           seed.diagonals, k))
            return fn(flat, seed, stride, k)
        return wrapped

    cap.patch(anchor_cuda, "seed_block_max_cuda", block_max)
    cap.patch(anchor_cuda, "seed_block_topk_cuda", topk)


def read(ctx):
    tr = ctx["trace"]
    name = "seed_block_max_kernel"
    bounds = [roofline.seed_block_bound_s(*s)
              for s in ctx["cap"].data.get(KEY, [])]
    return roofline.share(bounds, tr.device_s(name), tr.count(name))
