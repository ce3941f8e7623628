"""Experiment configuration: typed dataclass + JSON override merge
(counterpart of ``aonerf.utils.config``).

The fields are the ones the vanilla, auto-decoder and auto-encoder paths
read, with the JAX package's names and defaults; ``ALIASES`` maps the reference's flag names, so the repo's
config/*.json files load unchanged. Unknown keys are kept in ``extras``;
``JAX_ONLY_DEFAULTS`` names those that are fields of the JAX package's Config
the port does not run yet, and ``train.loop`` refuses a run that sets one of
them to anything but JAX's default.
"""

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass
class Config:
    # experiment
    exp_type: str = "vanilla"
    exp_name: str = "exp"
    dataset_name: str = "sapien"
    root_dir: str = ""
    output_path: str = "./results"
    render_name: str = "render"  # test() writes its images under run_dir/render_name
    run_eval: bool = False
    seed: int = 0

    # data
    img_wh: Tuple[int, int] = (640, 480)
    white_back: bool = True
    batch_size: int = 2048  # rays per step
    chunk: int = 256  # eval rays per tile (a multiple of the kernels' 16-ray tile)

    # field
    num_coarse_samples: int = 64
    num_fine_samples: int = 128
    # encoding degrees of every field: sample points over [min_deg_point,
    # max_deg_point), view directions over [0, deg_view)
    min_deg_point: int = 0
    max_deg_point: int = 10
    deg_view: int = 4
    # read by no model, as in the JAX Trainer (its mlp_kwargs hold neither):
    # every field is 8x256 whatever these say
    netdepth: int = 8
    netwidth: int = 256
    noise_std: float = 0.0
    lindisp: bool = False
    compute_dtype: str = "f32"  # "f32" or "bf16": the fused kernels' mode (vanilla only)
    # auto-decoder codes and the articulated field's compute schedule
    n_max_objs: int = 4
    obj_code_dim: int = 128
    n_max_articulations: int = 10
    art_code_dim: int = 32
    code_reg_weight: float = 1e-4
    latent_dense: bool = True  # contract latent columns per view (models/articulated.py)
    # auto-encoder (vanilla_ae_art): the opacity loss (train/step_ae.py's
    # OPACITY_LOSSES), the photometric loss over fg pixels ('masked') or all
    # ('full'), the field's density activation and degree embedding, the
    # views encoded a step and the steps one encode serves (train/step_ae.py)
    ae_opacity_loss: str = "bce_prob"
    ae_photometric: str = "masked"
    opacity_lambda: float = 0.5
    ae_sigma_activation: str = "softplus"
    ae_embed_deg: bool = True
    ae_views_per_step: int = 1
    ae_encode_reuse: int = 1

    # optimization
    lr_init: float = 5.0e-4
    lr_final: float = 5.0e-6
    lr_delay_steps: int = 2500
    lr_delay_mult: float = 0.01
    run_max_steps: int = 100_000
    # "adam" with no lr_scheduler is Adam with the log-lerp schedule above;
    # otherwise train/optim.py's optimizer (sgd | adam = AdamW | radam |
    # ranger) with its epoch-granular schedule (steplr | cosine | poly) and
    # the gradual warmup (not for radam and ranger)
    optimizer: str = "adam"
    lr_scheduler: Optional[str] = None
    momentum: float = 0.9
    weight_decay: float = 0.0
    decay_step: Tuple[int, ...] = (20,)
    decay_gamma: float = 0.1
    poly_exp: float = 0.99
    warmup_multiplier: float = 1.0
    warmup_epochs: int = 0
    latent_lr: Optional[float] = None  # the auto-decoder's codes by their own AdamW at this lr
    grad_clip: float = 0.0  # global-norm clip; 0 = off
    num_epochs: int = 100
    steps_per_epoch: int = 1000
    randomized: bool = True
    inner_steps: int = 10  # train steps per call of the multi-step
    samples_per_epoch: int = 4000

    # checkpointing / eval cadence
    ckpt_keep: int = 5
    ckpt_every_steps: int = 2000
    val_every_steps: int = 1000
    limit_val_batches: int = 5
    ckpt_path: Optional[str] = None
    weight_path: Optional[str] = None
    # the reference's launcher variants (run.py:38-61): both save every
    # steps_per_epoch steps; is_optimize also keeps every checkpoint
    is_optimize: bool = False
    finetune_lpips: bool = False

    # articulated test(): the instance the spheric sweep renders and its
    # number of poses (= interpolated articulation ids)
    render_instance: int = 0
    test_sweep_poses: int = 19
    # test-time code optimization (train/optimize.py, cli --run_optimize)
    optimize_instance: int = 0
    optimize_steps: int = 500
    optimize_lr: float = 1.0e-2

    # device: None = cuda (under torchrun cuda:LOCAL_RANK, NCCL); "cpu" runs
    # the plain versions on the host (gloo); "cuda:0" puts every rank on
    # that card (gloo)
    platform: Optional[str] = None
    # data parallel: each rank holds only its cyclic view slice of the
    # articulated scene buffers (False: every rank holds all of them)
    shard_scene_buffers: bool = True
    # >0: a torch.profiler trace of that many steps under run_dir/profile
    profile_steps: int = 0
    # raise FloatingPointError at the first step whose loss, outputs or
    # gradients hold a NaN (the reference's detect_anomaly)
    debug_nans: bool = False

    extras: Dict[str, Any] = field(default_factory=dict)


# The JAX package's Config fields that this Config lacks, with JAX's defaults
# (aonerf/utils/config.py). tests/test_torch_trainer.py holds the table to
# that dataclass.
JAX_ONLY_DEFAULTS: Dict[str, Any] = {
    "n_model_shards": 1,
}

# reference flag name -> Config field
ALIASES = {
    "N_samples": "num_coarse_samples",
    "N_importance": "num_fine_samples",
    "N_emb_xyz": "max_deg_point",
    "N_emb_dir": "deg_view",
    "N_max_objs": "n_max_objs",
    "N_obj_code_length": "obj_code_dim",
    "use_disp": "lindisp",
    "D": "netdepth",
    "W": "netwidth",
    "lr": "lr_init",
    "save_path": "render_name",
    "perturb": "randomized",  # the reference treats it as a 0/1 factor
}


def _coerce(name: str, value: Any) -> Any:
    if name in ("img_wh", "decay_step") and isinstance(value, (list, tuple)):
        return tuple(int(v) for v in value)
    if name == "randomized" and not isinstance(value, bool):
        return bool(value)
    return value


def load_config(path: Optional[str] = None, overrides: Optional[Dict[str, Any]] = None) -> Config:
    """A Config from an optional JSON file plus explicit overrides (the
    overrides win)."""
    cfg = Config()
    fields = {f.name for f in dataclasses.fields(Config)}

    def apply(d: Dict[str, Any]):
        for key, value in d.items():
            name = ALIASES.get(key, key)
            if name in fields and name != "extras":
                setattr(cfg, name, _coerce(name, value))
            else:
                cfg.extras[key] = value

    if path:
        with open(path) as f:
            apply(json.load(f))
    if overrides:
        apply({k: v for k, v in overrides.items() if v is not None})
    return cfg


def jax_only_settings(cfg: Config) -> Dict[str, Any]:
    """The keys of ``cfg.extras`` that set a field of ``JAX_ONLY_DEFAULTS``
    (by name or alias) to another value than JAX's default, by field name."""
    out = {}
    for key, value in cfg.extras.items():
        name = ALIASES.get(key, key)
        if name in JAX_ONLY_DEFAULTS:
            given = tuple(value) if isinstance(value, list) else value
            if given != JAX_ONLY_DEFAULTS[name]:
                out[name] = value
    return out
