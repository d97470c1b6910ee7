"""Model FLOPs of an ART forward, and the shapes of its attention calls,
worked out from a configuration's `network_g` and the input's shape alone,
not from any implementation.

Counted as `flops.py` counts WaveMamba: a multiply-add is two FLOPs, as
`torch.utils.flop_counter` counts them; biases, norms, activations, softmax
and other elementwise work are not counted. `forward_flops` splits the
count three ways: 'conv' (the stem, the fusion 1x1 and the output conv),
'linear' (qkv, proj, the MLP and the position-bias MLP), 'attention' (the
score and value products, q k^T and p v). Each attention runs over its own
zero-padded grid: qkv, proj and the products count the pad tokens; the
fusion and the MLP run on the unpadded grid.
"""

from __future__ import annotations


def _dims(g: dict):
    u = g["upscaling_factor"]
    c = u * g["dim"]
    return u, c, g["num_heads"], g["window_size"], g["interval"], int(c * g["mlp_ratio"])


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def groupings(g: dict, h: int, w: int):
    """[(kind, groups, gh, gw, pad_classes)] of one block on an h x w input
    (a multiple of the unshuffle): the dense windows and the sparse sets,
    the grid each group holds, and how many distinct patterns of pad keys
    its groups have (1 without a pad; up to 4: none, pad rows, pad columns,
    both)."""
    u, _, _, window, interval, _ = _dims(g)
    th, tw = h // u, w // u
    out = []
    for kind, size in (("dense", min(window, th, tw)), ("sparse", interval)):
        ph, pw = _up(th, size), _up(tw, size)
        if kind == "dense":
            groups, gh, gw = (ph // size) * (pw // size), size, size
        else:
            groups, gh, gw = size * size, ph // size, pw // size
        classes = (1 + (ph > th)) * (1 + (pw > tw))
        out.append((kind, groups, gh, gw, classes))
    return out


def attention_calls(g: dict, batch: int, h: int, w: int):
    """[(B, heads, N, hd, masks, offsets)] of one forward's attentions, one
    entry an attention (two a block): the groups of all the batch, heads, N
    tokens a group, the head width, how many distinct (heads, N, N) masks it
    needs (its pad classes), and the rows of its bias MLP table."""
    _, c, heads, _, _, _ = _dims(g)
    calls = []
    for _ in range(g["n_blocks"]):
        for _, groups, gh, gw, classes in groupings(g, h, w):
            calls.append((batch * groups, heads, gh * gw, c // heads, classes,
                          (2 * gh - 1) * (2 * gw - 1)))
    return calls


def forward_flops(g: dict, batch: int, h: int, w: int) -> dict:
    """{'conv', 'linear', 'attention'} FLOPs of one forward of `batch`
    images of h x w (multiples of the unshuffle)."""
    u, c, heads, _, _, hidden = _dims(g)
    t = (h // u) * (w // u)
    pos = c // 4 // 4  # the position-bias MLP's width: the block's dim / 4, over 4
    f = {"conv": 0, "linear": 0, "attention": 0}
    f["conv"] += 2 * batch * h * w * (g["dim"] // u) * 3 * 9  # stem, before the unshuffle
    f["conv"] += 2 * batch * t * (3 * u * u) * c * 9  # output conv, before the shuffle
    for _ in range(g["n_blocks"]):
        for _, groups, gh, gw, _ in groupings(g, h, w):
            n = gh * gw
            tokens = batch * groups * n  # the padded grid
            f["linear"] += 2 * tokens * c * 3 * c + 2 * tokens * c * c  # qkv, proj
            f["linear"] += 2 * (2 * gh - 1) * (2 * gw - 1) * (2 * pos + 2 * pos * pos + pos * heads)
            f["attention"] += 2 * 2 * batch * groups * n * n * c  # q k^T and p v, all heads
        f["conv"] += 2 * batch * t * 2 * c * c  # fusion
        f["linear"] += 2 * 2 * batch * t * c * hidden  # fc1, fc2
    return f


def model_flops(g: dict, batch: int, h: int, w: int) -> int:
    """All three parts of `forward_flops`: the forward's model FLOPs."""
    return sum(forward_flops(g, batch, h, w).values())
