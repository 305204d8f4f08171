"""The toy transformer of ``arch_toyvit.py`` as a module the program's
Engine can hold in place of its pose net, for the benchmark's own tests:
it computes as the port's models do in bfloat16 (weights stored in the
compute dtype, the port's conv layers and BatchNorm, LayerNorm in float32
on a bfloat16 input, the final 1x1 conv in float32)."""

import torch
import torch.nn.functional as F
from torch import nn

from multi_view_active_learning_tpu_torch.models import layers


class LayerNorm(nn.LayerNorm):
    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(),
                            self.bias.float(), self.eps).to(x.dtype)


class Block(nn.Module):
    def __init__(self, d, heads, hidden):
        super().__init__()
        self.heads = heads
        self.norm1, self.norm2 = LayerNorm(d, eps=1e-6), LayerNorm(d, eps=1e-6)
        self.attn = nn.Module()
        self.attn.qkv, self.attn.proj = nn.Linear(d, 3 * d), nn.Linear(d, d)
        self.mlp = nn.Module()
        self.mlp.fc1, self.mlp.fc2 = nn.Linear(d, hidden), nn.Linear(hidden, d)

    def forward(self, t):
        n, length, d = t.shape
        q, k, v = self.attn.qkv(self.norm1(t)).split(d, dim=-1)
        q, k, v = (u.reshape(n, length, self.heads, d // self.heads).transpose(1, 2)
                   for u in (q, k, v))
        a = F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(n, length, d)
        t = t + self.attn.proj(a)
        return t + self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(t))))


class ToyViT(nn.Module):
    def __init__(self, model, image_size: int, dtype=torch.bfloat16):
        super().__init__()
        p, d = int(model["patch_size"]), int(model["embed_dim"])
        tokens = (image_size // p) ** 2
        self.patch_embed = nn.Module()
        self.patch_embed.proj = layers.Conv2d(3, d, p, stride=p)
        self.pos_embed = nn.Parameter(torch.zeros(1, tokens, d))
        self.blocks = nn.ModuleList(
            Block(d, int(model["num_heads"]), int(model["mlp_ratio"]) * d)
            for _ in range(int(model["depth"])))
        self.last_norm = LayerNorm(d, eps=1e-6)
        head, cin = [], d
        for _ in range(int(model["num_deconv_layers"])):
            f = int(model["num_deconv_filters"])
            head += [layers.ConvTranspose2d(cin, f, 4, stride=2, padding=1, bias=False),
                     layers.BatchNorm2d(f), nn.ReLU(inplace=True)]
            cin = f
        self.deconv_layers = nn.Sequential(*head)
        self.final_layer = nn.Conv2d(cin, int(model["num_joints"]), 1)
        self.to(dtype)
        for m in self.modules():
            if isinstance(m, (layers.BatchNorm2d, LayerNorm)):
                m.float()
        self.final_layer.float()

    def forward(self, x):
        t = self.patch_embed.proj(x)
        n, d, gh, gw = t.shape
        t = t.flatten(2).transpose(1, 2) + self.pos_embed.to(t.dtype)
        for block in self.blocks:
            t = block(t)
        x = self.last_norm(t).transpose(1, 2).reshape(n, d, gh, gw)
        return self.final_layer(self.deconv_layers(x).to(torch.float32))
