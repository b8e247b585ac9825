"""Per-layer cost tables for the paper's evaluation models.

The planner/simulator benchmarks reproduce the paper's tables with the same
four models: EfficientNet-B1, MobileNetV2, ResNet-50 (vision) and BERT-small
(language).  The CNNs are *cost tables* (exact per-block FLOPs/params/
activation sizes derived from the architecture definitions) — the JAX-
executable model zoo covers the ten assigned transformer architectures;
DESIGN.md records this split.

Inputs match the paper: CIFAR-10 3x32x32 for EfficientNet-B1/MobileNetV2,
Mini-ImageNet 3x224x224 for ResNet-50, and 512-token sequences for
BERT-small.
"""

from __future__ import annotations

from repro_torch.core.profiler import ACT_BYTES, PARAM_BYTES, LayerCost, LayerTable


def _conv_cost(name, h, w, cin, cout, k, stride=1, groups=1):
    """Output activation is (cout, h/stride, w/stride)."""
    ho, wo = -(-h // stride), -(-w // stride)
    flops = 2.0 * ho * wo * cout * cin // groups * k * k
    params = cout * cin // groups * k * k + 2 * cout   # + BN
    act = cout * ho * wo * ACT_BYTES
    return LayerCost(name, flops, params * PARAM_BYTES, act), ho, wo


def _inverted_residual(name, h, w, cin, cout, expand, k, stride):
    """MobileNet/EfficientNet MBConv block as one planner layer."""
    mid = cin * expand
    flops = 0.0
    params = 0.0
    if expand != 1:
        flops += 2.0 * h * w * cin * mid            # 1x1 expand
        params += cin * mid + 2 * mid
    ho, wo = -(-h // stride), -(-w // stride)
    flops += 2.0 * ho * wo * mid * k * k            # depthwise
    params += mid * k * k + 2 * mid
    flops += 2.0 * ho * wo * mid * cout             # 1x1 project
    params += mid * cout + 2 * cout
    act = cout * ho * wo * ACT_BYTES
    return LayerCost(name, flops, params * PARAM_BYTES, act), ho, wo


def mobilenet_v2(input_hw: int = 32) -> LayerTable:
    """MobileNetV2 (width 1.0).  [Sandler et al., CVPR'18]"""
    cfg = [  # (expand, cout, n, stride)
        (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
    ]
    layers = []
    h = w = input_hw
    stem, h, w = _conv_cost("stem", h, w, 3, 32, 3, stride=2 if input_hw > 64 else 1)
    layers.append(stem)
    cin = 32
    for bi, (t, c, n, s) in enumerate(cfg):
        for i in range(n):
            blk, h, w = _inverted_residual(f"mb{bi}_{i}", h, w, cin, c, t, 3,
                                           s if i == 0 else 1)
            layers.append(blk)
            cin = c
    head, h, w = _conv_cost("head_conv", h, w, cin, 1280, 1)
    layers.append(head)
    fc = LayerCost("classifier", 2.0 * 1280 * 1000, 1280 * 1000 * PARAM_BYTES,
                   1000 * ACT_BYTES)
    layers.append(fc)
    return LayerTable("mobilenetv2", tuple(layers))


def efficientnet_b1(input_hw: int = 32) -> LayerTable:
    """EfficientNet-B1 (width 1.0, depth 1.1 on the B0 skeleton)."""
    b0 = [  # (expand, cout, n, stride, k)
        (1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5), (6, 80, 3, 2, 3),
        (6, 112, 3, 1, 5), (6, 192, 4, 2, 5), (6, 320, 1, 1, 3),
    ]
    import math
    depth = lambda n: int(math.ceil(n * 1.1))
    layers = []
    h = w = input_hw
    stem, h, w = _conv_cost("stem", h, w, 3, 32, 3, stride=2 if input_hw > 64 else 1)
    layers.append(stem)
    cin = 32
    for bi, (t, c, n, s, k) in enumerate(b0):
        for i in range(depth(n)):
            blk, h, w = _inverted_residual(f"mb{bi}_{i}", h, w, cin, c, t, k,
                                           s if i == 0 else 1)
            layers.append(blk)
            cin = c
    head, h, w = _conv_cost("head_conv", h, w, cin, 1280, 1)
    layers.append(head)
    layers.append(LayerCost("classifier", 2.0 * 1280 * 1000,
                            1280 * 1000 * PARAM_BYTES, 1000 * ACT_BYTES))
    return LayerTable("efficientnet-b1", tuple(layers))


def resnet50(input_hw: int = 224) -> LayerTable:
    """ResNet-50 bottleneck stacks [He et al., CVPR'16]."""
    stages = [(64, 256, 3, 1), (128, 512, 4, 2), (256, 1024, 6, 2),
              (512, 2048, 3, 2)]
    layers = []
    h = w = input_hw
    stem, h, w = _conv_cost("stem7x7", h, w, 3, 64, 7, stride=2)
    layers.append(stem)
    h, w = h // 2, w // 2     # maxpool
    cin = 64
    for si, (mid, cout, n, stride) in enumerate(stages):
        for i in range(n):
            s = stride if i == 0 else 1
            ho, wo = -(-h // s), -(-w // s)
            flops = (2.0 * h * w * cin * mid +
                     2.0 * ho * wo * mid * mid * 9 +
                     2.0 * ho * wo * mid * cout)
            params = cin * mid + mid * mid * 9 + mid * cout + 2 * (2 * mid + cout)
            if i == 0:
                flops += 2.0 * ho * wo * cin * cout     # projection shortcut
                params += cin * cout + 2 * cout
            act = cout * ho * wo * ACT_BYTES
            layers.append(LayerCost(f"res{si}_{i}", flops,
                                    params * PARAM_BYTES, act))
            h, w, cin = ho, wo, cout
    layers.append(LayerCost("classifier", 2.0 * 2048 * 1000,
                            2048 * 1000 * PARAM_BYTES, 1000 * ACT_BYTES))
    return LayerTable("resnet50", tuple(layers))


def bert_small(seq_len: int = 32) -> LayerTable:
    """BERT-small: 4 layers, d=512, 8 heads [Devlin et al.].

    The paper's synthetic input is 32x512 = (seq 32, hidden 512): short
    sequences make activations tiny relative to the 110 MB of parameters —
    exactly why its planner picks a straight pipeline for BERT."""
    from repro_torch.models.config import AttentionConfig, LayerSpec, ModelConfig
    cfg = ModelConfig(name="bert-small", n_layers=4, d_model=512,
                      vocab_size=30522, d_ff=2048,
                      attn=AttentionConfig(n_heads=8, n_kv_heads=8, head_dim=64),
                      pattern=(LayerSpec(),))
    table = LayerTable.from_model_config(cfg, seq_len=seq_len)
    # the paper trains on synthetic data with a small task head (not a full
    # vocab LM head): swap the final layer for a CLS classifier
    cls = LayerCost("cls_head", 2.0 * 512 * 2, 512 * 2 * PARAM_BYTES,
                    2 * ACT_BYTES)
    return LayerTable("bert-small", table.layers[:-1] + (cls,))


def efficientnet_b1_fine(input_hw: int = 32) -> LayerTable:
    """EfficientNet-B1 at sub-block granularity (~80 planner layers),
    approximating the paper's 213-layer planning granularity (Table 7)."""
    coarse = efficientnet_b1(input_hw)
    layers = []
    for lc in coarse.layers:
        if lc.name.startswith("mb"):
            # split expand / depthwise / project thirds
            for i, frac in enumerate((0.45, 0.2, 0.35)):
                layers.append(LayerCost(f"{lc.name}.{i}", lc.flops_fwd * frac,
                                        lc.param_bytes * frac,
                                        lc.act_bytes))
        else:
            layers.append(lc)
    return LayerTable("efficientnet-b1-fine", tuple(layers))


PAPER_MODELS = {
    "efficientnet-b1": lambda: efficientnet_b1(32),
    "mobilenetv2": lambda: mobilenet_v2(32),
    "resnet50": lambda: resnet50(224),
    "bert-small": lambda: bert_small(32),
}

# global mini-batch sizes used in the paper's Table 4
PAPER_BATCH = {"efficientnet-b1": 2048, "mobilenetv2": 2048,
               "resnet50": 256, "bert-small": 2048}
