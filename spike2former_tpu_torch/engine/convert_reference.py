"""Reference checkpoint keys -> the JAX-shaped variable tree (a numpy copy
of ``convert_spike2former`` and the backbone converters of
``spike2former_tpu/engine/convert.py``, ``convert_sdtv2.py`` and
``convert_sdtv3.py``).

The reference's parameter names (mmseg ``EncoderDecoder``: ``backbone.*``
from Spiking_vit_MetaFormer, sdtv2.py:424-655, Spiking_vit_MetaFormerv2,
sdtv3.py:401-616, or Spiking_vit_MetaFormerv3, sdtv3MAE.py:526-750, and
``decode_head.*`` from the MaskFormer head, maskformer_head.py:68-168)
map onto the flax module
tree of the JAX package, whose names the port's modules keep; conv
kernels turn OIHW -> HWIO there, and ``engine/convert.py:
from_jax_variables`` turns them back.  The result is for a ``compat=True``
model: the reference computes through layout reinterpretations (the
MSDA_FFN reshape shuffle, transformer.py:777-781; the MS_MLP output
reshape :831; the DCNv3 offset/mask reshape, dcnv3.py:213-215) that the
trained weights encode.

Every key is read through ``Consumed``, so a key that no part of the
model takes (a key of another variant, a misspelt one) is reported.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np


class Consumed(dict):
    """A state dict that records which keys were read."""

    def __init__(self, sd: Mapping[str, Any]):
        super().__init__(sd)
        self.read: set[str] = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def _set(tree: dict, path: list[str], value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _conv(sd, key, params, path):
    """torch conv weight [O, I/g, kh, kw] -> flax HWIO [kh, kw, I/g, O]."""
    _set(params, path + ["kernel"],
         np.transpose(np.asarray(sd[key + ".weight"]), (2, 3, 1, 0)))
    if key + ".bias" in sd:
        _set(params, path + ["bias"], np.asarray(sd[key + ".bias"]))


def _bn(sd, key, params, stats, path):
    """torch BN -> the flax BatchNorm wrapper (inner 'BatchNorm_0')."""
    _bn_raw(sd, key, params, stats, path + ["BatchNorm_0"])


def _bn_raw(sd, key, params, stats, path):
    """torch BN -> a bare flax param/stat group (BNAndPad stores directly)."""
    _set(params, path + ["scale"], np.asarray(sd[key + ".weight"]))
    _set(params, path + ["bias"], np.asarray(sd[key + ".bias"]))
    _set(stats, path + ["mean"], np.asarray(sd[key + ".running_mean"]))
    _set(stats, path + ["var"], np.asarray(sd[key + ".running_var"]))


def _convbn(sd, conv_key, bn_key, params, stats, path):
    _conv(sd, conv_key, params, path + ["Conv_0"])
    _bn(sd, bn_key, params, stats, path + ["BatchNorm_0"])


def _conv1d(sd, key, params, path):
    """torch Conv1d weight [O, I, 1] -> flax kernel [1, I, O]."""
    w = np.asarray(sd[key + ".weight"])
    _set(params, path + ["kernel"], np.transpose(w, (2, 1, 0)))
    if key + ".bias" in sd:
        _set(params, path + ["bias"], np.asarray(sd[key + ".bias"]))


def _dense(sd, key, params, path):
    """torch Linear [O, I] -> flax [I, O]."""
    _set(params, path + ["kernel"], np.asarray(sd[key + ".weight"]).T)
    if key + ".bias" in sd:
        _set(params, path + ["bias"], np.asarray(sd[key + ".bias"]))


# ---- the SDTv2 backbone (sdtv2.py:424-655) ----------------------------------

def _sepconv(sd, pfx, params, stats, path):
    """SepConv (:135-180): pwconv1+bn1, dwconv (no BN), pwconv2+bn2."""
    _convbn(sd, f"{pfx}.pwconv1", f"{pfx}.bn1", params, stats,
            path + ["ConvBN_0"])
    _conv(sd, f"{pfx}.dwconv", params, path + ["Conv_0"])
    _convbn(sd, f"{pfx}.pwconv2", f"{pfx}.bn2", params, stats,
            path + ["ConvBN_1"])


def _convblock(sd, pfx, params, stats, path):
    """MS_ConvBlock (:183-219)."""
    _sepconv(sd, f"{pfx}.Conv", params, stats, path + ["SepConv_0"])
    _convbn(sd, f"{pfx}.conv1", f"{pfx}.bn1", params, stats,
            path + ["ConvBN_0"])
    _convbn(sd, f"{pfx}.conv2", f"{pfx}.bn2", params, stats,
            path + ["ConvBN_1"])


def _repconv(sd, pfx, params, stats, path):
    """RepConv (:112-132): body.0 conv1x1, body.1 BNAndPad, body.2.{0 dw,
    1 pw, 2 BN}."""
    _conv(sd, f"{pfx}.body.0", params, path + ["Conv_0"])
    _bn_raw(sd, f"{pfx}.body.1.bn", params, stats, path + ["BNAndPad_0"])
    _conv(sd, f"{pfx}.body.2.0", params, path + ["Conv_1"])
    _conv(sd, f"{pfx}.body.2.1", params, path + ["Conv_2"])
    _bn(sd, f"{pfx}.body.2.2", params, stats, path + ["BatchNorm_0"])


def _downsample(sd, pfx, params, stats, path):
    _conv(sd, f"{pfx}.encode_conv", params, path + ["Conv_0"])
    _bn(sd, f"{pfx}.encode_bn", params, stats, path + ["BatchNorm_0"])


def _attention(sd, pfx, params, stats, path):
    """MS_Attention_RepConv_qkv_id (:258-344): q/k/v/proj = RepConv + BN."""
    for name in ("q", "k", "v", "proj"):
        _repconv(sd, f"{pfx}.{name}_conv.0", params, stats,
                 path + [f"{name}_rep"])
        _bn(sd, f"{pfx}.{name}_conv.1", params, stats, path + [f"{name}_bn"])


def _mlp(sd, pfx, params, stats, path):
    """MS_MLP (:222-255): fc1_conv (Conv1d) + fc1_bn, fc2_conv + fc2_bn;
    the Conv1d weight [O, I, 1] becomes the pointwise 2-D conv kernel
    [1, 1, I, O]."""
    for conv, bn, i in (("fc1_conv", "fc1_bn", 0), ("fc2_conv", "fc2_bn", 1)):
        w = np.asarray(sd[f"{pfx}.{conv}.weight"])
        _set(params, path + [f"Conv_{i}", "kernel"],
             np.transpose(w, (2, 1, 0))[None])
        _set(params, path + [f"Conv_{i}", "bias"],
             np.asarray(sd[f"{pfx}.{conv}.bias"]))
        _bn(sd, f"{pfx}.{bn}", params, stats, path + [f"BatchNorm_{i}"])


def convert_sdtv2_backbone(sd, depths_stage3: int = 6,
                           depths_stage4: int = 2) -> dict[str, Any]:
    """{'params', 'batch_stats'} of the SDTv2 ``SpikingMetaFormer`` from
    the backbone's keys, ``backbone.`` stripped."""
    params: dict = {}
    stats: dict = {}
    _downsample(sd, "downsample1_1", params, stats, ["down1_1"])
    _convblock(sd, "ConvBlock1_1.0", params, stats, ["conv1_1"])
    _downsample(sd, "downsample1_2", params, stats, ["down1_2"])
    _convblock(sd, "ConvBlock1_2.0", params, stats, ["conv1_2"])
    _downsample(sd, "downsample2", params, stats, ["down2"])
    _convblock(sd, "ConvBlock2_1.0", params, stats, ["conv2_1"])
    _convblock(sd, "ConvBlock2_2.0", params, stats, ["conv2_2"])
    _downsample(sd, "downsample3", params, stats, ["down3"])
    for i in range(depths_stage3):
        _attention(sd, f"block3.{i}.attn", params, stats,
                   [f"block3_{i}", "SpikeAttention_0"])
        _mlp(sd, f"block3.{i}.mlp", params, stats, [f"block3_{i}", "MSMLP_0"])
    _downsample(sd, "downsample4", params, stats, ["down4"])
    for i in range(depths_stage4):
        _attention(sd, f"block4.{i}.attn", params, stats,
                   [f"block4_{i}", "SpikeAttention_0"])
        _mlp(sd, f"block4.{i}.mlp", params, stats, [f"block4_{i}", "MSMLP_0"])
    return {"params": params, "batch_stats": stats}


# ---- the SDTv3 backbones (sdtv3.py:401-616, sdtv3MAE.py:526-750) -----------

def _convblock_v3(sd, pfx, params, stats, path):
    """MS_ConvBlock_spike_SepConv (sdtv3.py:153-189) or the MAE file's
    MS_ConvBlock (sdtv3MAE.py:172-209): SepConv_Spike, then conv1/bn1,
    conv2/bn2."""
    _sepconv_spike(sd, f"{pfx}.Conv", params, stats, path + ["SepConv_0"])
    _convbn(sd, f"{pfx}.conv1", f"{pfx}.bn1", params, stats,
            path + ["ConvBN_0"])
    _convbn(sd, f"{pfx}.conv2", f"{pfx}.bn2", params, stats,
            path + ["ConvBN_1"])


def _block_v3(sd, pfx, params, stats, path, *, mae: bool):
    """MS_Block_Spike_SepConv (sdtv3.py:321-360) or MS_Block_cswin
    (sdtv3MAE.py:439-483, with ``layer_scale{1,2,3}``): a SepConv_Spike,
    the attention's q/k/v/proj as 1x1 conv + BN (MS_Attention_linear,
    sdtv3.py:229-313, or its CSWin form, sdtv3MAE.py:349-436) and the
    MLP of Conv1d(k=1) + BN pairs."""
    if mae:
        for g in ("layer_scale1", "layer_scale2", "layer_scale3"):
            _set(params, path + [g], np.asarray(sd[f"{pfx}.{g}"]))
    _sepconv_spike(sd, f"{pfx}.conv", params, stats, path + ["SepConv_0"])
    attn = path + ["CSWinSpikeAttention_0" if mae else "SpikeAttention_0"]
    for name in ("q", "k", "v", "proj"):
        _convbn(sd, f"{pfx}.attn.{name}_conv.0", f"{pfx}.attn.{name}_conv.1",
                params, stats, attn + [f"{name}_conv"])
    _mlp(sd, f"{pfx}.mlp", params, stats, path + ["MSMLP_0"])


def convert_sdtv3_backbone(sd, depths_stage3: int = 6, depths_stage4: int = 2,
                           *, mae: bool = False) -> dict[str, Any]:
    """{'params', 'batch_stats'} of the ``variant='sdtv3'`` (or, with
    ``mae``, ``'sdtv3mae'``) ``SpikingMetaFormer`` from the backbone's
    keys, ``backbone.`` stripped.  The MAE flavour has no
    ``downsample4``."""
    params: dict = {}
    stats: dict = {}
    _downsample(sd, "downsample1_1", params, stats, ["down1_1"])
    _convblock_v3(sd, "ConvBlock1_1.0", params, stats, ["conv1_1"])
    _downsample(sd, "downsample1_2", params, stats, ["down1_2"])
    _convblock_v3(sd, "ConvBlock1_2.0", params, stats, ["conv1_2"])
    _downsample(sd, "downsample2", params, stats, ["down2"])
    _convblock_v3(sd, "ConvBlock2_1.0", params, stats, ["conv2_1"])
    _convblock_v3(sd, "ConvBlock2_2.0", params, stats, ["conv2_2"])
    _downsample(sd, "downsample3", params, stats, ["down3"])
    for i in range(depths_stage3):
        _block_v3(sd, f"block3.{i}", params, stats, [f"block3_{i}"], mae=mae)
    if not mae:
        _downsample(sd, "downsample4", params, stats, ["down4"])
    for i in range(depths_stage4):
        _block_v3(sd, f"block4.{i}", params, stats, [f"block4_{i}"], mae=mae)
    return {"params": params, "batch_stats": stats}


# ---- the MaskFormer head (maskformer_head.py:68-168) ------------------------

def _sepconv_spike(sd, pfx, params, stats, path):
    """SepConv_Spike (SNN_core.py:11-63): pwconv1.{0 conv, 1 bn},
    dwconv.{0, 1}, pwconv2.{0, 1}."""
    _convbn(sd, f"{pfx}.pwconv1.0", f"{pfx}.pwconv1.1", params, stats,
            path + ["ConvBN_0"])
    _conv(sd, f"{pfx}.dwconv.0", params, path + ["Conv_0"])
    _bn(sd, f"{pfx}.dwconv.1", params, stats, path + ["BatchNorm_0"])
    _convbn(sd, f"{pfx}.pwconv2.0", f"{pfx}.pwconv2.1", params, stats,
            path + ["ConvBN_1"])


def _token_convbn(sd, pfx, params, stats, path):
    """A Conv1d(k=1) + BatchNorm1d pair (``q_conv``-style Sequential)."""
    _conv1d(sd, f"{pfx}.0", params, path + ["Conv_0"])
    _bn(sd, f"{pfx}.1", params, stats, path + ["BatchNorm_0"])


def _spike_mha(sd, pfx, params, stats, path):
    """(Cross)MultiHeadAttentionBlock (transformer.py:196-361): q/k/v/out
    Conv1d + BN stacks."""
    for name in ("q", "k", "v"):
        _token_convbn(sd, f"{pfx}.{name}_conv", params, stats, path + [name])
    _token_convbn(sd, f"{pfx}.out_conv", params, stats, path)


def _ffn(sd, pfx, params, stats, path, keys):
    """MSDA_FFN (fc1/bn1/fc2/bn2, :760-766) or MS_MLP (fc1_conv/fc1_bn/...,
    :810-816) -> MSDAFFN {Conv_0, BatchNorm_0, Conv_1, BatchNorm_1}."""
    _conv1d(sd, f"{pfx}.{keys[0]}", params, path + ["Conv_0"])
    _bn(sd, f"{pfx}.{keys[1]}", params, stats, path + ["BatchNorm_0"])
    _conv1d(sd, f"{pfx}.{keys[2]}", params, path + ["Conv_1"])
    _bn(sd, f"{pfx}.{keys[3]}", params, stats, path + ["BatchNorm_1"])


def _dcnv3(sd, pfx, params, stats, path):
    """DCNv3_pytorch (modules/dcnv3.py:96-233)."""
    _conv(sd, f"{pfx}.dw_conv.0", params, path + ["dw_conv"])
    _bn(sd, f"{pfx}.dw_conv.1", params, stats, path + ["dw_bn"])
    _conv(sd, f"{pfx}.offset.0", params, path + ["offset_conv"])
    _bn(sd, f"{pfx}.offset.1", params, stats, path + ["offset_bn"])
    _conv(sd, f"{pfx}.mask.0", params, path + ["mask_conv"])
    _bn(sd, f"{pfx}.mask.1", params, stats, path + ["mask_bn"])
    _sepconv_spike(sd, f"{pfx}.input_proj", params, stats,
                   path + ["input_proj"])
    _sepconv_spike(sd, f"{pfx}.output_proj", params, stats,
                   path + ["output_proj"])


def _pixel_decoder(sd, params, stats, *, num_inputs: int,
                   num_encoder_layers: int, pfx: str = "pixel_decoder"):
    """DCNTransformerEncoderPixelDecoder (pixel_decoder.py:316-472).  The
    reference walks its lateral and output lists from the highest index
    down (:455-466), the flax tree from 0 up: the indices are reversed."""
    path = ["pixel_decoder"]
    _convbn(sd, f"{pfx}.encoder_in_proj.0", f"{pfx}.encoder_in_proj.1",
            params, stats, path + ["encoder_in_proj"])
    _convbn(sd, f"{pfx}.encoder_out_proj.0", f"{pfx}.encoder_out_proj.1",
            params, stats, path + ["encoder_out_proj"])
    for j in range(num_inputs - 1):
        idx = num_inputs - 2 - j
        _convbn(sd, f"{pfx}.lateral_convs.{j}.0",
                f"{pfx}.lateral_convs.{j}.1", params, stats,
                path + [f"lateral_{idx}"])
        _conv(sd, f"{pfx}.output_convs.{j}.0", params,
              path + [f"output_conv_{idx}"])
        _bn(sd, f"{pfx}.output_convs.{j}.1", params, stats,
            path + [f"output_bn_{idx}"])
    _conv(sd, f"{pfx}.mask_feature", params, path + ["mask_feature"])
    for i in range(num_encoder_layers):
        lpfx, lpath = f"{pfx}.encoder.layers.{i}", path + [f"encoder_{i}"]
        # DCNDetrTransformerEncoderLayer (detr_layers.py:263-339)
        for g in ("gamma1", "gamma2", "gamma3"):
            _set(params, lpath + [g], np.asarray(sd[f"{lpfx}.{g}"]))
        _sepconv_spike(sd, f"{lpfx}.Conv", params, stats, lpath + ["conv"])
        _dcnv3(sd, f"{lpfx}.dcn", params, stats, lpath + ["dcn"])
        _ffn(sd, f"{lpfx}.ffn", params, stats, lpath + ["ffn"],
             ("fc1_conv", "fc1_bn", "fc2_conv", "fc2_bn"))


def convert_maskformer_head(sd, *, num_inputs: int = 4,
                            num_encoder_layers: int = 6,
                            num_decoder_layers: int = 6) -> dict[str, Any]:
    """{'params', 'batch_stats'} of the ``MaskFormerHead`` from the head's
    keys, ``decode_head.`` stripped."""
    params: dict = {}
    stats: dict = {}
    _pixel_decoder(sd, params, stats, num_inputs=num_inputs,
                   num_encoder_layers=num_encoder_layers)
    for i in range(num_decoder_layers):
        dpfx, dpath = f"transformer_decoder.layers.{i}", [f"decoder_{i}"]
        _spike_mha(sd, f"{dpfx}.self_attn.attn", params, stats,
                   dpath + ["self_attn"])
        _spike_mha(sd, f"{dpfx}.cross_attn.attn", params, stats,
                   dpath + ["cross_attn"])
        _ffn(sd, f"{dpfx}.ffn", params, stats, dpath + ["ffn"],
             ("fc1", "bn1", "fc2", "bn2"))
    for emb in ("query_embed", "query_feat", "level_embed"):
        _set(params, [emb], np.asarray(sd[f"{emb}.weight"]))
    _dense(sd, "cls_embed", params, ["cls_embed"])
    _dense(sd, "mask_embed.fc1", params, ["mask_embed", "Dense_0"])
    _dense(sd, "mask_embed.fc2", params, ["mask_embed", "Dense_1"])
    _dense(sd, "mask_embed.fc_out", params, ["mask_embed", "Dense_2"])
    # a Conv1d over the query axis, weight [nq, nq, 1] -> [nq, nq]
    _set(params, ["shortcut_kernel"],
         np.asarray(sd["shortcut_conv.0.weight"])[:, :, 0])
    _bn(sd, "shortcut_conv.1", params, stats, ["shortcut_bn"])
    _set(params, ["w"], np.asarray(sd["w"]).reshape(1))
    return {"params": params, "batch_stats": stats}


BACKBONES = ("sdtv2", "sdtv3", "sdtv3mae")


def convert_spike2former(sd: Mapping[str, Any], *, variant: str = "sdtv2",
                         depths_stage3: int = 6, depths_stage4: int = 2,
                         num_inputs: int = 4, num_encoder_layers: int = 6,
                         num_decoder_layers: int = 6) -> dict[str, Any]:
    """A full reference ``EncoderDecoder`` state dict (``backbone.*`` and
    ``decode_head.*``, numpy arrays) -> the variable tree of a
    ``compat=True`` Spike2Former with the ``variant`` backbone (``sdtv2``,
    ``sdtv3`` or ``sdtv3mae``).  Raises ``KeyError`` for a key the
    variant's map needs and the dict lacks (a state dict of another
    variant fails so) or a key the model does not take (BN
    ``num_batches_tracked`` counters aside)."""
    if variant not in BACKBONES:
        raise ValueError(f"unknown backbone variant {variant!r}")
    parts = {pfx: Consumed({k[len(pfx):]: v for k, v in sd.items()
                            if k.startswith(pfx)})
             for pfx in ("backbone.", "decode_head.")}
    if not parts["decode_head."]:
        raise KeyError("no 'decode_head.*' keys: this looks like a "
                       "backbone-only checkpoint")
    if variant == "sdtv2":
        backbone = convert_sdtv2_backbone(parts["backbone."], depths_stage3,
                                          depths_stage4)
    else:
        backbone = convert_sdtv3_backbone(
            parts["backbone."], depths_stage3, depths_stage4,
            mae=variant == "sdtv3mae")
    head = convert_maskformer_head(
        parts["decode_head."], num_inputs=num_inputs,
        num_encoder_layers=num_encoder_layers,
        num_decoder_layers=num_decoder_layers)
    taken = {pfx + k for pfx, part in parts.items() for k in part.read}
    unused = sorted(k for k in set(sd) - taken
                    if not k.endswith(".num_batches_tracked"))
    if unused:
        raise KeyError(f"{len(unused)} reference keys taken by no part of "
                       f"the model, e.g. {unused[:5]}")
    return {"params": {"backbone": backbone["params"],
                       "head": head["params"]},
            "batch_stats": {"backbone": backbone["batch_stats"],
                            "head": head["batch_stats"]}}
