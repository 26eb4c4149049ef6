"""CLIP ViT-B/32's two towers (Radford et al. 2021; openai/CLIP
`clip/model.py`), the frozen backbone of GALIP (`models/galip.py`).

Parameters carry OpenAI's state_dict names (`visual.conv1.weight`,
`visual.transformer.resblocks.{i}.attn.in_proj_weight`, `token_embedding`,
`text_projection`, ...), so the state_dict of OpenAI's `ViT-B-32.pt` loads
with `load_state_dict(strict=True)` (`load_openai_state_dict` drops the
three entries that are not weights). Without such a file the towers are
seeded at random (`CLIP(cfg)` with torch's default inits).

Each residual block is pre-LN: `x = x + attn(ln_1(x))`, then
`x = x + c_proj(QuickGELU(c_fc(ln_2(x))))`, LayerNorm eps 1e-5; the
attention is multi-head with a fused `in_proj` and `out_proj`, through
`F.scaled_dot_product_attention` (causal in the text tower).

- `encode_image(img)`: G's or the data's NHWC image in [-1, 1] ->
  (the local features after the visual blocks `layers`, [B, L, g, g, W]
  NHWC with g = 224 / 32, and the global embedding `ln_post(x[:, 0]) @
  proj` [B, E]). The image is taken to [0, 1], resized nearest to the
  tower's resolution (the identity at 224) and normalized by CLIP's mean
  and std.
- `encode_text(ids)`: ids [B, 77] framed with start- and end-of-text
  (`data/dataset.py`) -> the sentence [B, E], the row of the end-of-text
  token (the largest id) after `ln_final`, times `text_projection`.
- `map_features(f, prompts)`: GALIP's mapper, the visual blocks on a
  feature map f [B, g, g, W] in place of the patch tokens, with prompt k
  appended before block k + 1 and dropped after it.

`forward(captions, cap_lens)` is `encode_text`, so the model takes the
text encoder's place in the trainer (the lengths are not needed: the
end-of-text token marks each caption's end). The spans `clip.text`,
`clip.image` and `galip.mapper` (`utils/profiling.py::span`) time each
call on the device under a profiler, and `tokens` counts the tokens that
entered a tower, each block counted once.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import CLIPConfig
from ..ops import nn as ops_nn
from ..utils.profiling import span

MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)
NOT_WEIGHTS = ("input_resolution", "context_length", "vocab_size")


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.attn = nn.MultiheadAttention(width, heads)  # its parameters
        self.ln_1 = nn.LayerNorm(width)
        self.mlp = nn.Sequential()
        self.mlp.add_module("c_fc", nn.Linear(width, 4 * width))
        self.mlp.add_module("c_proj", nn.Linear(4 * width, width))
        self.ln_2 = nn.LayerNorm(width)

    def forward(self, x: torch.Tensor, causal: bool = False) -> torch.Tensor:
        """x [B, T, W] (batch first)."""
        b, t, w = x.shape
        h = F.layer_norm(x, (w,), self.ln_1.weight, self.ln_1.bias, 1e-5)
        qkv = F.linear(h, self.attn.in_proj_weight, self.attn.in_proj_bias)
        q, k, v = qkv.view(b, t, 3, self.heads, w // self.heads).permute(
            2, 0, 3, 1, 4)
        a = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        a = a.transpose(1, 2).reshape(b, t, w)
        x = x + F.linear(a, self.attn.out_proj.weight, self.attn.out_proj.bias)
        h = F.layer_norm(x, (w,), self.ln_2.weight, self.ln_2.bias, 1e-5)
        h = F.linear(h, self.mlp.c_fc.weight, self.mlp.c_fc.bias)
        h = h * torch.sigmoid(1.702 * h)  # QuickGELU
        return x + F.linear(h, self.mlp.c_proj.weight, self.mlp.c_proj.bias)


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int):
        super().__init__()
        self.resblocks = nn.Sequential(*(ResidualAttentionBlock(width, heads)
                                         for _ in range(layers)))


class VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        w, p = cfg.vision_width, cfg.vision_patch_size
        scale = w ** -0.5
        self.conv1 = nn.Conv2d(3, w, p, stride=p, bias=False)
        self.class_embedding = nn.Parameter(scale * torch.randn(w))
        self.positional_embedding = nn.Parameter(
            scale * torch.randn(cfg.grid ** 2 + 1, w))
        self.ln_pre = nn.LayerNorm(w)
        self.transformer = Transformer(w, cfg.vision_layers, cfg.vision_heads)
        self.ln_post = nn.LayerNorm(w)
        self.proj = nn.Parameter(scale * torch.randn(w, cfg.embed_dim))


def _ln(x: torch.Tensor, ln: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x, ln.normalized_shape, ln.weight, ln.bias, 1e-5)


class CLIP(nn.Module):
    def __init__(self, cfg: CLIPConfig):
        super().__init__()
        self.cfg = cfg
        self.visual = VisionTransformer(cfg)
        self.transformer = Transformer(cfg.transformer_width,
                                       cfg.transformer_layers,
                                       cfg.transformer_heads)
        self.token_embedding = nn.Embedding(cfg.vocab_size,
                                            cfg.transformer_width)
        self.positional_embedding = nn.Parameter(
            0.01 * torch.randn(cfg.context_length, cfg.transformer_width))
        self.ln_final = nn.LayerNorm(cfg.transformer_width)
        self.text_projection = nn.Parameter(
            cfg.transformer_width ** -0.5
            * torch.randn(cfg.transformer_width, cfg.embed_dim))
        self.logit_scale = nn.Parameter(torch.tensor(4.6052))
        self.tokens = 0  # tokens through the towers' blocks, per block
        mean, std = torch.tensor(MEAN), torch.tensor(STD)
        self.register_buffer("pixel_mean", mean, persistent=False)
        self.register_buffer("pixel_std", std, persistent=False)

    # -- text -----------------------------------------------------------------

    def encode_text(self, ids: torch.Tensor) -> torch.Tensor:
        """ids [B, T] -> sentences [B, E]."""
        with span("clip.text", ids.device):
            ids = ids.long()
            x = self.token_embedding(ids) + self.positional_embedding[
                :ids.shape[1]]
            for block in self.transformer.resblocks:
                x = block(x, causal=True)
            self.tokens += ids.numel()
            x = _ln(x, self.ln_final)
            rows = x[torch.arange(x.shape[0], device=x.device),
                     ids.argmax(dim=-1)]
            return rows @ self.text_projection

    def forward(self, captions: torch.Tensor,
                cap_lens: torch.Tensor = None) -> torch.Tensor:
        return self.encode_text(captions)

    # -- image ----------------------------------------------------------------

    def _tokens(self, patches: torch.Tensor) -> torch.Tensor:
        """[B, g, g, W] patch features -> [B, g*g + 1, W]: the class token
        first, the positions added, `ln_pre`."""
        v = self.visual
        b, g, _, w = patches.shape
        x = torch.cat([v.class_embedding.to(patches.dtype).expand(b, 1, w),
                       patches.reshape(b, g * g, w)], dim=1)
        return _ln(x + v.positional_embedding.to(x.dtype), v.ln_pre)

    def encode_image(self, img: torch.Tensor,
                     layers: Sequence[int] = (1, 4, 8)
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """img [B, H, W, 3] NHWC in [-1, 1] -> (local [B, len(layers), g,
        g, W] NHWC, global [B, E])."""
        with span("clip.image", img.device):
            v, r = self.visual, self.cfg.image_resolution
            x = img * 0.5 + 0.5
            if x.shape[1:3] != (r, r):
                x = ops_nn.resize_nearest(x, r)
            x = (x - self.pixel_mean.to(x.dtype)) / self.pixel_std.to(x.dtype)
            patches = ops_nn.conv2d(x, v.conv1.weight,
                                    stride=self.cfg.vision_patch_size)
            g = patches.shape[1]
            x = self._tokens(patches)
            local = []
            blocks = v.transformer.resblocks
            for i, block in enumerate(blocks):
                x = block(x)
                if i in layers:
                    local.append(x[:, 1:].reshape(x.shape[0], g, g,
                                                  x.shape[-1]))
            self.tokens += x.shape[0] * x.shape[1]
            glob = _ln(x[:, 0], v.ln_post) @ v.proj.to(x.dtype)
            return torch.stack(local, dim=1), glob

    def map_features(self, f: torch.Tensor, prompts: torch.Tensor
                     ) -> torch.Tensor:
        """GALIP's mapper: f [B, g, g, W] NHWC, prompts [B, P, W] ->
        [B, g, g, W]: the visual blocks on f's tokens (no conv1, no
        ln_post), prompt k appended before block k + 1, dropped after."""
        with span("galip.mapper", f.device):
            b, g, _, w = f.shape
            x = self._tokens(f)
            n = x.shape[1]
            prompts = prompts.to(x.dtype)
            for i, block in enumerate(self.visual.transformer.resblocks):
                if 1 <= i <= prompts.shape[1]:
                    x = block(torch.cat([x, prompts[:, i - 1:i]], dim=1))[
                        :, :n]
                else:
                    x = block(x)
            self.tokens += b * n
            return x[:, 1:].reshape(b, g, g, w)


def load_openai_state_dict(model: CLIP, sd: Dict[str, torch.Tensor]) -> CLIP:
    """Load OpenAI's CLIP state_dict (the `state_dict()` of the module in
    `ViT-B-32.pt`, or that file's TorchScript model's) into `model`,
    strict, in float32; the entries that are not weights are dropped."""
    sd = {k: v.float() for k, v in sd.items() if k not in NOT_WEIGHTS}
    model.load_state_dict(sd, strict=True)
    return model
