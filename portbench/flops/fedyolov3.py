"""Model FLOPs of one fedyolov3 training sample: 3 x the forward's products
(forward, and the backward's two products per forward product: the
gradients of the weights and of the input; no recompute), less the stem's
input gradient, which no one needs (its input is the image). The forward's
products are the convolutions' multiply-adds, 2 H_out W_out C_out C_in k_h
k_w each, at the mix's image size."""


def stem_flops(sizes: dict, mix: dict) -> float:
    return 2.0 * mix["img_size"] ** 2 * sizes["d_model"] * 3 * 3 * 3


def forward_flops(sizes: dict, mix: dict) -> float:
    c, A, K = sizes["d_model"], sizes["n_heads"], sizes["vocab_size"]
    n_stages = max(sizes["n_layers"], 3)
    widths = [c * 2 ** min(i + 1, 5) for i in range(n_stages)]
    side = mix["img_size"]
    conv = lambda s, k, cin, cout: 2.0 * s * s * cout * cin * k * k
    total = stem_flops(sizes, mix)
    cin, sides = c, []
    for w in widths:
        side = -(-side // 2)
        total += conv(side, 3, cin, w) + conv(side, 1, w, w // 2) + conv(side, 3, w // 2, w)
        sides.append(side)
        cin = w
    for s, w in zip(sides[-3:], widths[-3:]):
        total += conv(s, 1, w, A * (5 + K))
    return total


def flops_per_sample(sizes: dict, mix: dict) -> float:
    return 3.0 * forward_flops(sizes, mix) - stem_flops(sizes, mix)
