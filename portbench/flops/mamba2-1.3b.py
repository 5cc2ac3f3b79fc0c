"""Model FLOPs of one Mamba2 training sequence: 3 x the forward's products
(forward, and the backward's two products per forward product; no
recompute). Per token and layer: the in projections (z, x, B, C, dt) and
the out projection; per chunk of Q tokens the SSD's products: C B^T over
the chunk (Q^2 N), its product with x (Q^2 H P), the chunk's state (Q H P
N) and the entering state's product with C (Q H P N); per token the tied
logits over the padded vocabulary."""


def forward_flops(sizes: dict, mix: dict) -> float:
    d, L, S, Q = sizes["d_model"], sizes["n_layers"], mix["seq"], sizes["ssm_chunk"]
    di = sizes["ssm_expand"] * d
    P, N = sizes["ssm_headdim"], sizes["ssm_state"]
    H = di // P
    vocab = -(-sizes["vocab_size"] // 16) * 16
    proj = 2.0 * d * (2 * di + 2 * N + H) + 2.0 * di * d
    ssd_chunk = 2.0 * (Q * Q * N + Q * Q * H * P + 2 * Q * H * P * N)
    return S * (L * proj + 2.0 * d * vocab) + L * (S // Q) * ssd_chunk


def flops_per_sample(sizes: dict, mix: dict) -> float:
    return 3.0 * forward_flops(sizes, mix)
