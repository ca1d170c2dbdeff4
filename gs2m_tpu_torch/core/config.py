"""Configuration system: dataclass groups + auto-generated CLI + saved-config merge.

Port of gs2m_tpu/core/config.py: the same three groups with the same flag
names, defaults and shorthands, so the port reads a `cfg_args.json` written
by the JAX trainer (and the JAX apps read one written here). The pipeline
group keeps the JAX package's blend knobs for file compatibility; the
port's render path reads `tile`, `chunk` and `instance_cap_mult`.
`use_pallas`, `compact_bwd` and `term_cut` have no effect here (the
trainer prints a notice when `term_cut` is set).
"""
from __future__ import annotations

import dataclasses
import json
import os
from argparse import ArgumentParser, BooleanOptionalAction, Namespace
from dataclasses import dataclass, fields

# Fields whose CLI flag also gets a single-letter shorthand.
_SHORTHAND = {"source_path": "-s", "model_path": "-m", "images": "-i",
              "resolution": "-r", "white_background": "-w"}


@dataclass
class ModelConfig:
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = -1
    white_background: bool = False
    eval: bool = False
    # GS-IR
    gamma: bool = False
    metallic: bool = False
    # GS-2M
    material: bool = False
    mask_gt: bool = False
    masks: str = ""
    depths: str = ""


@dataclass
class PipelineConfig:
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    z_depth: bool = False
    debug: bool = False
    tile: int = 16                      # pixel tile edge for binning
    chunk: int = 256                    # Gaussians per blend chunk
    instance_cap_mult: float = 4.0      # instance buffer ~ mult * capacity
    use_pallas: bool = True
    compact_bwd: bool = True
    term_cut: bool = False              # no effect here (see above)


@dataclass
class OptimConfig:
    iterations: int = 30_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.001
    lambda_ssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    opacity_prune_threshold: float = 0.005
    densify_from_iter: int = 500
    densify_until_iter: int = 15_000
    densify_grad_threshold: float = 0.0002
    # AbsGS
    densify_grad_abs_threshold: float = 0.0008
    use_opacity_reduce: bool = False
    opacity_reduce_interval: int = 500
    prune_init_points: bool = True
    radii2D_threshold: float = 20
    # PGSR multi-view
    multi_view_num: int = 8
    multi_view_ncc_weight: float = 0.15
    multi_view_geo_weight: float = 2e-3
    multi_view_ncc_scale: float = -1.0
    multi_view_max_angle: float = 30
    multi_view_min_dist: float = 0.01
    multi_view_max_dist: float = 1.5
    use_multi_view_trim: bool = True
    multi_view_sample_num: int = 102400
    multi_view_patch_size: int = 3
    # GS-2M staging & material
    geometry_from_iter: int = 5000
    material_from_iter: int = 30_000
    lambda_alpha: float = 0.2
    lambda_plane: float = 100.0
    lambda_depth_normal: float = 0.03
    lambda_multi_view: float = 1.0
    lambda_normal: float = 0.1
    lambda_smooth: float = 0.0
    lambda_rough: float = 1e-4
    mv_angle_threshold: float = 30
    mv_angle_factor: float = 2.0
    mv_occlusion_threshold: float = 5e-4
    mv_geo_weight_decay: float = 3.0
    reflection_threshold: float = 1.0
    nearby_cam_num: int = 16
    nearby_cam_max_angle: float = 60
    nearby_cam_min_angle: float = 10
    nearby_cam_min_dist: float = 0.05
    nearby_cam_max_dist: float = 2.5


def add_group_args(parser: ArgumentParser, cls, fill_none: bool = False) -> None:
    """One flag per dataclass field; booleans get --flag/--no-flag pairs.
    fill_none: default every flag to None so combine_args can tell what the
    user typed from what the saved config should supply."""
    for f in fields(cls):
        names = ["--" + f.name] + ([_SHORTHAND[f.name]]
                                   if f.name in _SHORTHAND else [])
        default = None if fill_none else f.default
        if f.type in (bool, "bool"):
            parser.add_argument(*names, default=default,
                                action=BooleanOptionalAction)
        else:
            typ = {int: int, float: float, str: str,
                   "int": int, "float": float, "str": str}[f.type]
            parser.add_argument(*names, default=default, type=typ)


def extract_group(args: Namespace, cls):
    kwargs = {}
    for f in fields(cls):
        v = getattr(args, f.name, None)
        kwargs[f.name] = f.default if v is None else v
    cfg = cls(**kwargs)
    if isinstance(cfg, ModelConfig) and cfg.source_path:
        cfg.source_path = os.path.abspath(cfg.source_path)
    return cfg


def save_cfg_args(model_path: str, model: ModelConfig, pipeline: PipelineConfig,
                  optim: OptimConfig) -> None:
    """Persist the merged config next to the model as cfg_args.json."""
    os.makedirs(model_path, exist_ok=True)
    blob = {
        "model": dataclasses.asdict(model),
        "pipeline": dataclasses.asdict(pipeline),
        "optim": dataclasses.asdict(optim),
    }
    with open(os.path.join(model_path, "cfg_args.json"), "w") as f:
        json.dump(blob, f, indent=2)


def load_cfg_args(model_path: str):
    path = os.path.join(model_path, "cfg_args.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        blob = json.load(f)
    return (ModelConfig(**blob["model"]), PipelineConfig(**blob["pipeline"]),
            OptimConfig(**blob["optim"]))


def combine_args(parser: ArgumentParser, argv=None):
    """CLI-over-saved-config merge: values the user typed win; everything
    else comes from the saved cfg_args.json."""
    args = parser.parse_args(argv)
    saved = (load_cfg_args(args.model_path)
             if getattr(args, "model_path", None) else None)
    model = extract_group(args, ModelConfig)
    pipeline = extract_group(args, PipelineConfig)
    optim = extract_group(args, OptimConfig)
    if saved is not None:
        for cfg, scfg in zip((model, pipeline, optim), saved):
            for f in fields(cfg):
                if getattr(args, f.name, None) is None and hasattr(scfg, f.name):
                    setattr(cfg, f.name, getattr(scfg, f.name))
    return args, model, pipeline, optim
