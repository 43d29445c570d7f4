"""Plain-PyTorch mirror of the bfloat16 rounding of the SSD scan backward's
bfloat16 kernels (csrc/mamba_scan_bwd.cu), shared by the CPU tests.

The kernels run every product on the bfloat16 tensor cores with float32
accumulators. A product of two bfloat16 inputs (the scores dy.v and q.k)
is exact in float32 and is taken as it is. A float32 operand (the decayed
masked scores, the chunk states S_{c-1} and G_c, exp(l) q in the adjoint
state's sum) is either split in two, hi = bf16(x) and lo = bf16(x - hi),
each multiplying its exact bfloat16 partner (the kernels' way), or
rounded once to bf16(x). Everything else is `mamba_scan_backward_plain`'s
float32 arithmetic: the row dots q.dq and k.dk on the unrounded float32
gradients, the adjoint walk and dlog_a's reverse sums. Returns float32
(dq, dk, dv, dlog_a), before the kernels' one rounding of dq, dk, dv to
bfloat16.
"""
import torch

from repro_torch.kernels.mamba_scan.mamba_scan import _by_heads


def parts(x, split: bool):
    """The bfloat16 operand(s) a float32 x becomes, as float32 values:
    (lo, hi) when split (lo first, as the kernels add them), else (hi,)."""
    hi = x.to(torch.bfloat16).float()
    return ((x - hi).to(torch.bfloat16).float(), hi) if split else (hi,)


def mirror_backward(q, k, v, dy, st, lc, *, chunk: int, split: bool):
    """(dq, dk, dv, dlog_a) in float32 from bfloat16 q, k, v, dy (q, k of
    (B, S, 1, N) shared by the heads, or per head) and the forward's
    float32 kept states st and l of each chunk lc."""
    shared = q.shape[2] != v.shape[2]
    qh, kh = _by_heads(q, k, v)
    B, S, H, N = qh.shape
    Pd = v.shape[-1]
    Q = int(chunk)
    nc = -(-S // Q)
    pad = nc * Q - S

    def chunks(t):
        t = torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0, pad))
        return t.reshape(B, nc, Q, H, t.shape[-1])

    def mix(eq, x, y):   # x float32 (rounded), y an exact bfloat16 value
        return sum(torch.einsum(eq, p, y) for p in parts(x, split))

    qc, kc, vc, dc = chunks(qh), chunks(kh), chunks(v), chunks(dy)
    causal = torch.ones((Q, Q), dtype=torch.bool).tril()
    G = torch.zeros((B, H, N, Pd))
    dqs, dks, dvs, dls = [], [], [], []
    for c in reversed(range(nc)):
        qb, kb, vb, db = qc[:, c], kc[:, c], vc[:, c], dc[:, c]
        l = lc[:, :, c].float().transpose(1, 2)
        total = l[:, -1]
        s_prev = st[:, :, c].float()
        e = torch.exp(torch.clamp(l[:, :, None] - l[:, None, :], -60.0,
                                  0.0)).permute(0, 3, 1, 2)
        e = torch.where(causal, e, torch.zeros_like(e))
        w = torch.exp(torch.clamp(total[:, None] - l, -60.0, 0.0))
        dyv = torch.einsum("bihp,bjhp->bhij", db, vb) * e
        qk = torch.einsum("bihn,bjhn->bhij", qb, kb) * e
        dq = mix("bhij,bjhn->bihn", dyv, kb) + mix(
            "bhnp,bihp->bihn", s_prev, db) * torch.exp(l)[..., None]
        dk = mix("bhij,bihn->bjhn", dyv, qb) + mix(
            "bhnp,bjhp->bjhn", G, vb) * w[..., None]
        dv = mix("bhij,bihp->bjhp", qk, db) + mix(
            "bhnp,bjhn->bjhp", G, kb) * w[..., None]
        dl = (qb * dq).sum(-1) - (kb * dk).sum(-1)
        if c + 1 < nc:
            tail = (G * st[:, :, c + 1].float()).sum((-1, -2))
            dl = torch.cat([dl[:, :-1], dl[:, -1:] + tail[:, None]], 1)
        dls.append(torch.flip(torch.cumsum(torch.flip(dl, (1,)), 1), (1,)))
        dqs.append(dq)
        dks.append(dk)
        dvs.append(dv)
        G = G * torch.exp(total)[:, :, None, None] + mix(
            "bihn,bihp->bhnp", qb * torch.exp(l)[..., None], db)

    def whole(ps):
        t = torch.stack(ps[::-1], 1)
        return t.reshape(B, nc * Q, *t.shape[3:])[:, :S]
    dq, dk = whole(dqs), whole(dks)
    if shared:
        dq, dk = dq.sum(2, keepdim=True), dk.sum(2, keepdim=True)
    return dq, dk, whole(dvs), whole([d[..., None] for d in dls])[..., 0]
