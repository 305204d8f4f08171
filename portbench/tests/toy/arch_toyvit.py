"""A toy plain vision transformer with ViTPose's simple head, for the
benchmark's own tests (not a configuration): patches embedded by a
linear map, a learned position table, pre-LN blocks of multi-head
attention and a GELU MLP, a last LayerNorm, then transposed convs and a
1x1 conv to the heatmaps at stride 4.  The tests copy it into
``reference/`` as ``arch_toyvit.py``, where ``arch.forward`` finds it by
the configuration's ``arch``."""


def forward(P, ops, x, model):
    n, c, h, w = x.shape
    p, d = int(model["patch_size"]), int(model["embed_dim"])
    heads, hidden = int(model["num_heads"]), int(model["mlp_ratio"]) * int(model["embed_dim"])
    gh, gw = h // p, w // p
    t = x.reshape(n, c, gh, p, gw, p).permute(0, 2, 4, 1, 3, 5).reshape(n, gh * gw, c * p * p)
    t = ops.linear(P, "patch_embed.proj", t, c * p * p, d, shape=(d, c, p, p))
    t = ops.add(t, P.get("pos_embed", (1, gh * gw, d), "table"))
    for i in range(int(model["depth"])):
        b = "blocks.%d." % i
        y = ops.layer_norm(P, b + "norm1", t, d)
        q, k, v = ops.linear(P, b + "attn.qkv", y, d, 3 * d).split(d, dim=-1)
        t = ops.add(t, ops.linear(P, b + "attn.proj", ops.attention(q, k, v, heads), d, d))
        y = ops.layer_norm(P, b + "norm2", t, d)
        y = ops.gelu(ops.linear(P, b + "mlp.fc1", y, d, hidden))
        t = ops.add(t, ops.linear(P, b + "mlp.fc2", y, hidden, d))
    t = ops.layer_norm(P, "last_norm", t, d)
    x = t.transpose(1, 2).reshape(n, d, gh, gw)
    cin, filters = d, int(model["num_deconv_filters"])
    for i in range(int(model["num_deconv_layers"])):
        x = ops.deconv_unit(P, "deconv_layers.%d" % (3 * i), "deconv_layers.%d" % (3 * i + 1), x,
                            cin, filters, int(model["num_deconv_kernel"]))
        cin = filters
    return ops.final(P, "final_layer", x, cin, int(model["num_joints"]), 1)
