"""State-dict names for the JAX package's variable paths.

The port's modules carry the reference PyTorch state_dict names
(`core.branch_2d.fnet.layer1.0.conv1.weight`, ...). These tables translate a
JAX variable path (`core/fnet_2d/layer1_0/conv1/kernel`) into that name: a
per-model prefix swap (longest match wins), then token rewrites of the rest
of the path. Same tables and rules as tools/port_checkpoint.py, for the
models the port has; beside them `mlps_<i>` (FusionAwareInterpCVPR's MLP,
the reference's `mlps` Sequential). With no model name a path is a bare
module's own (`interp/score_net_0/Dense_0/kernel`): the rules alone name it.
"""

from __future__ import annotations

import re

# per-model table of (JAX prefix -> state_dict prefix)
PREFIX_TABLES = {
    "camliraft": [
        ("core/fnet_2d/", "core.branch_2d.fnet."),
        ("core/cnet_2d/", "core.branch_2d.cnet."),
        ("core/cnet_aligner_2d/", "core.branch_2d.cnet_aligner."),
        ("core/fnet_aligner_2d/", "core.branch_2d.correlation.fnet_aligner."),
        ("core/update/motion_encoder_2d/", "core.branch_2d.motion_encoder."),
        ("core/update/gru_2d/", "core.branch_2d.gru."),
        ("core/update/flow_head_2d/", "core.branch_2d.flow_head."),
        ("core/update/convex_upsampler/", "core.branch_2d.convex_upsampler."),
        ("core/fnet_3d/", "core.branch_3d.fnet."),
        ("core/cnet_3d/", "core.branch_3d.cnet."),
        ("core/cnet_aligner_3d/", "core.branch_3d.cnet_aligner."),
        ("core/update/correlation_3d/", "core.branch_3d.correlation."),
        ("core/update/motion_encoder_3d/", "core.branch_3d.motion_encoder."),
        ("core/update/gru_3d/", "core.branch_3d.gru."),
        ("core/update/flow_head_3d/", "core.branch_3d.flow_head."),
        ("core/clfm_fnet/", "core.clfm_fnet."),
        ("core/clfm_cnet/", "core.clfm_cnet."),
        ("core/update/clfm_corr/", "core.clfm_corr."),
        ("core/update/clfm_motion/", "core.clfm_motion."),
        ("core/update/clfm_hidden/", "core.clfm_hidden."),
    ],
    "camliraft_l": [
        ("core/fnet/", "core.fnet."),
        ("core/cnet/", "core.cnet."),
        ("core/cnet_aligner/", "core.cnet_aligner."),
        ("core/update/correlation/", "core.correlation."),
        ("core/update/motion_encoder/", "core.motion_encoder."),
        ("core/update/gru/", "core.gru."),
        ("core/update/flow_head/", "core.flow_head."),
    ],
    "raft": [
        ("core/fnet/", "core.fnet."),
        ("core/cnet/", "core.cnet."),
        ("core/cnet_aligner/", "core.cnet_aligner."),
        ("core/fnet_aligner/", "core.correlation.fnet_aligner."),
        ("core/update/motion_encoder/", "core.motion_encoder."),
        ("core/update/gru/", "core.gru."),
        ("core/update/flow_head/", "core.flow_head."),
        ("core/update/convex_upsampler/", "core.convex_upsampler."),
    ],
    "pwc": [
        ("core/feature_pyramid/", "core.feature_pyramid."),
        ("core/aligner_1/", "core.pyramid_feature_aligners.1."),
        ("core/aligner_2/", "core.pyramid_feature_aligners.2."),
        ("core/aligner_3/", "core.pyramid_feature_aligners.3."),
        ("core/aligner_4/", "core.pyramid_feature_aligners.4."),
        ("core/aligner_5/", "core.pyramid_feature_aligners.5."),
        ("core/flow_estimator/", "core.flow_estimator."),
        ("core/context_network/", "core.context_network."),
        ("core/up_mask_head/conv0/", "core.up_mask_head.0."),
        ("core/up_mask_head/conv1/", "core.up_mask_head.2."),
    ],
    "camlipwc_l": [
        ("core/feature_pyramid/", "core.feature_pyramid."),
        ("core/correlation_1/", "core.correlations.1."),
        ("core/correlation_2/", "core.correlations.2."),
        ("core/correlation_3/", "core.correlations.3."),
        ("core/correlation_4/", "core.correlations.4."),
        ("core/correlation_5/", "core.correlations.5."),
        ("core/aligner_1/", "core.pyramid_feat_aligners.1."),
        ("core/aligner_2/", "core.pyramid_feat_aligners.2."),
        ("core/aligner_3/", "core.pyramid_feat_aligners.3."),
        ("core/aligner_4/", "core.pyramid_feat_aligners.4."),
        ("core/aligner_5/", "core.pyramid_feat_aligners.5."),
        ("core/flow_estimator/", "core.flow_estimator."),
    ],
    "camlipwc": [
        ("core/branch_2d_fnet/", "core.branch_2d_fnet."),
        ("core/fnet2d_aligner_1/", "core.branch_2d_fnet_aligners.1."),
        ("core/fnet2d_aligner_2/", "core.branch_2d_fnet_aligners.2."),
        ("core/fnet2d_aligner_3/", "core.branch_2d_fnet_aligners.3."),
        ("core/fnet2d_aligner_4/", "core.branch_2d_fnet_aligners.4."),
        ("core/fnet2d_aligner_5/", "core.branch_2d_fnet_aligners.5."),
        ("core/branch_2d_flow_estimator/", "core.branch_2d_flow_estimator."),
        ("core/branch_2d_context_network/", "core.branch_2d_context_network."),
        ("core/branch_2d_up_mask_head/conv0/", "core.branch_2d_up_mask_head.0."),
        ("core/branch_2d_up_mask_head/conv1/", "core.branch_2d_up_mask_head.2."),
        ("core/branch_3d_fnet/", "core.branch_3d_fnet."),
        ("core/fnet3d_aligner_1/", "core.branch_3d_fnet_aligners.1."),
        ("core/fnet3d_aligner_2/", "core.branch_3d_fnet_aligners.2."),
        ("core/fnet3d_aligner_3/", "core.branch_3d_fnet_aligners.3."),
        ("core/fnet3d_aligner_4/", "core.branch_3d_fnet_aligners.4."),
        ("core/fnet3d_aligner_5/", "core.branch_3d_fnet_aligners.5."),
        ("core/correlation3d_1/", "core.branch_3d_correlations.1."),
        ("core/correlation3d_2/", "core.branch_3d_correlations.2."),
        ("core/correlation3d_3/", "core.branch_3d_correlations.3."),
        ("core/correlation3d_4/", "core.branch_3d_correlations.4."),
        ("core/correlation3d_5/", "core.branch_3d_correlations.5."),
        ("core/corr3d_aligner_1/", "core.branch_3d_correlation_aligners.1."),
        ("core/corr3d_aligner_2/", "core.branch_3d_correlation_aligners.2."),
        ("core/corr3d_aligner_3/", "core.branch_3d_correlation_aligners.3."),
        ("core/corr3d_aligner_4/", "core.branch_3d_correlation_aligners.4."),
        ("core/corr3d_aligner_5/", "core.branch_3d_correlation_aligners.5."),
        ("core/branch_3d_flow_estimator/", "core.branch_3d_flow_estimator."),
        ("core/clfm_pyr_1/", "core.pyramid_clfms.1."),
        ("core/clfm_pyr_2/", "core.pyramid_clfms.2."),
        ("core/clfm_pyr_3/", "core.pyramid_clfms.3."),
        ("core/clfm_pyr_4/", "core.pyramid_clfms.4."),
        ("core/clfm_pyr_5/", "core.pyramid_clfms.5."),
        ("core/clfm_corr_1/", "core.corr_clfms.1."),
        ("core/clfm_corr_2/", "core.corr_clfms.2."),
        ("core/clfm_corr_3/", "core.corr_clfms.3."),
        ("core/clfm_corr_4/", "core.corr_clfms.4."),
        ("core/clfm_corr_5/", "core.corr_clfms.5."),
        ("core/clfm_estimator/", "core.estimator_clfm."),
        ("core/conv_last_2d/", "core.branch_2d_conv_last."),
        ("core/conv_last_3d/", "core.branch_3d_conv_last."),
    ],
}

# token-level rewrites of the path after the prefix swap
_SUFFIX_RULES = [
    # MLP members
    (r"DenseNormAct_(\d+)/Dense_0/(kernel|bias)", r"convs.\1.conv_fn.{w}"),
    (r"DenseNormAct_(\d+)/Norm_0/BatchNorm_0/(scale|bias|mean|var)", r"convs.\1.norm_fn.{bn}"),
    (r"DenseNormAct_(\d+)/Norm_0/InstanceNorm_0/(scale|bias)", r"convs.\1.norm_fn.{w}"),
    (r"DenseNormAct_(\d+)/Norm_0/LayerNorm_0/(scale|bias)", r"convs.\1.norm_fn.{w}"),
    # ConvexUpsampler2D mask head (Sequential 0, 2)
    (r"mask_0/(kernel|bias)", r"mask.0.{w}"),
    (r"mask_1/(kernel|bias)", r"mask.2.{w}"),
    # CLFM FusionAwareInterp score net (Sequential of Conv2dNormRelu)
    (r"score_net_0/Dense_0/(kernel|bias)", r"score_net.0.conv_fn.{w}"),
    (r"score_net_1/Dense_0/(kernel|bias)", r"score_net.1.conv_fn.{w}"),
    # SKFusion fc heads (Sequential(Linear, act))
    (r"fc_mid/kernel", r"fc_mid.0.weight"),
    (r"fc_out/kernel", r"fc_out.0.weight"),
    # generic Conv/Dense NormAct wrappers
    (r"Conv_0/(kernel|bias)", r"conv_fn.{w}"),
    (r"Dense_0/(kernel|bias)", r"conv_fn.{w}"),
    (r"Norm_0/BatchNorm_0/(scale|bias|mean|var)", r"norm_fn.{bn}"),
    (r"Norm_0/InstanceNorm_0/(scale|bias)", r"norm_fn.{w}"),
    (r"Norm_0/LayerNorm_0/(scale|bias)", r"norm_fn.{w}"),
    # FusionAwareInterpCVPR's MLP (a Sequential of Conv2dNormRelu)
    (r"mlps_(\d+)/", r"mlps.\1"),
    # PointConv / raw leaves
    (r"linear/(kernel|bias)", r"linear.{w}"),
    # ResNet
    (r"layer(\d)_(\d+)/downsample_conv/kernel", r"layer\1.\2.downsample.0.weight"),
    (r"layer(\d)_(\d+)/downsample_bn/(scale|bias|mean|var)", r"layer\1.\2.downsample.1.{bn}"),
    (r"layer(\d)_(\d+)/", r"layer\1.\2"),
    (r"bn(\d)/(scale|bias|mean|var)", r"bn\1.{bn}"),
    # raw convs/dense at the end (gru convz1, flow_head conv1, fc, ...)
    (r"([A-Za-z0-9_]+)/(kernel|bias)$", r"\1.{w}"),
    # bare leaves (when the prefix table consumed the whole module path)
    (r"(kernel)$", r"weight"),
    (r"(bias)$", r"bias"),
]

_BN_MAP = {"scale": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}


def translate_suffix(suffix: str, torch_prefix: str = "") -> str:
    """Translate the rest of a JAX path (after the prefix) to its
    state_dict suffix: the first rule that matches the whole remaining path
    is applied and the tail is translated in turn; otherwise one path
    segment is peeled (`mlp_<i>` -> `mlps.<i>`, `conv_<i>` -> `convs.<i>`,
    `block_<i>` -> `pyramid_convs.<i>`). Under a point feature pyramid's
    prefix (`torch_prefix` the state_dict prefix the table gave), whose
    reference members are `pyramid_mlps`/`pyramid_convs`, `mlp_<i>` and
    `conv_<i>` take those names."""
    pyramid = (("branch_3d_fnet" in torch_prefix or "feature_pyramid." in torch_prefix)
               and "branch_2d" not in torch_prefix)
    for pattern, template in _SUFFIX_RULES:
        m = re.match(pattern, suffix)
        if not m:
            continue
        leaf = m.groups()[-1] if m.groups() else ""
        t = template.replace("{w}", {"kernel": "weight", "scale": "weight"}.get(leaf, leaf))
        t = t.replace("{bn}", _BN_MAP.get(leaf, leaf))
        translated = m.expand(t)
        rest = suffix[m.end():]
        if rest:
            rest = translate_suffix(rest.lstrip("/"), torch_prefix)
            translated = translated + ("." if rest else "") + rest
        return translated

    if "/" in suffix:
        head, tail = suffix.split("/", 1)
        m = re.fullmatch(r"(mlp|conv|block)_(\d+)", head)
        if m:
            kind = "conv" if m.group(1) == "block" else m.group(1)
            pyramid_member = pyramid or m.group(1) == "block"
            head = f"{'pyramid_' if pyramid_member else ''}{kind}s.{m.group(2)}"
        return head + "." + translate_suffix(tail, torch_prefix)
    return suffix


def our_path_to_torch(path: str, model_name: str | None) -> str | None:
    """The state_dict name of a JAX variable path (without its collection),
    or None when no prefix of the model's table matches; with no model name
    the path's module is the bridged module itself."""
    if model_name is None:
        return translate_suffix(path)
    table = PREFIX_TABLES[model_name]
    for ours, theirs in sorted(table, key=lambda kv: -len(kv[0])):
        if path.startswith(ours):
            return theirs + translate_suffix(path[len(ours):], theirs)
    return None
