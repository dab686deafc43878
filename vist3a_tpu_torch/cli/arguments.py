"""CLI argument system — flag-compatible with the reference.

Port of `vist3a_tpu/cli/arguments.py` (the reference's `utils/argument.py`):
composable argparse groups (model selection, run/logging, training loop,
optimizer, data, stitching) with `BooleanOptionalAction` and a
defaults-shown formatter; dataset tokens `NAME:PATH` with existence
validation (:16-32); the five parser builders (:278-443); the post-parse
validator forcing `num_frames_per_unit_scene == 32` for VDM training
(:451-463).  Every flag name and default is the JAX package's, so its
launch commands port unchanged.

The mesh flags `--mesh_data`, `--mesh_model` and `--dit_sharding` parse
as the JAX package's do; `core/mesh.py` lays them over the ranks of a
`torchrun` launch (one process per GPU), and a layout that does not match
the world size raises on every rank.
"""

from __future__ import annotations

import argparse
import pathlib
import textwrap

from vist3a_tpu_torch.stitch.conv_spec import parse_conv_spec
from vist3a_tpu_torch.stitch.lora import parse_lora_mode  # noqa: F401 (re-export)


def parse_dataset(arg: str):
    """NAME:PATH token → (name, Path); validates existence
    (`utils/argument.py:16-32`)."""
    try:
        name, root = arg.split(":", 1)
    except ValueError:
        raise argparse.ArgumentTypeError(
            "Dataset must be NAME:PATH, e.g. dl3dv:/data/dl3dv")
    root_path = pathlib.Path(root).expanduser()
    if not root_path.exists():
        raise argparse.ArgumentTypeError(f"Path does not exist: {root_path}")
    return name, root_path


def make_parser(description: str) -> argparse.ArgumentParser:
    return argparse.ArgumentParser(
        description=description,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)


def _dedent(s: str) -> str:
    return textwrap.dedent(s).strip("\n")


# --------------------------------------------------------------------------- #
# reusable blocks                                                             #
# --------------------------------------------------------------------------- #
def add_model_selection_args(parser):
    g = parser.add_argument_group("Model selection")
    g.add_argument("--feedforward_model", type=str, default="anysplat",
                   choices=["anysplat"], help="Feedforward model to use")
    g.add_argument("--video_model", type=str, default="wan",
                   choices=["wan"], help="Video model to use")
    return parser


def add_run_and_logging_args(parser):
    g = parser.add_argument_group("Run & logging")
    g.add_argument("--global_seed", type=int, default=23, help="Global seed")
    g.add_argument("--exp_name", type=str, default="wan_anysplat_stitching",
                   help="Experiment name")
    g.add_argument("--wandb_logging", action=argparse.BooleanOptionalAction,
                   default=False, help="Enable wandb logging")
    g.add_argument("--wandb_project_name", type=str, default="wan+anysplat",
                   help="Wandb project name")
    return parser


def add_training_loop_args(parser):
    g = parser.add_argument_group("Training loop")
    g.add_argument("--num_epochs", type=int, default=10,
                   help="Number of training epochs")
    g.add_argument("--resume_checkpoint_path", type=str, default=None,
                   help="Path to resume checkpoint")
    g.add_argument("--save_path", type=str,
                   default="trained_checkpoint/wan_anysplat_stitching",
                   help="Path to save checkpoints")
    return parser


def add_optimizer_args(parser, *, include_warmup: bool = True):
    g = parser.add_argument_group("Optimizer")
    g.add_argument("--learning_rate", type=float, default=1e-4,
                   help="Learning rate")
    g.add_argument("--weight_decay", type=float, default=1e-4,
                   help="Weight decay")
    if include_warmup:
        g.add_argument("--warmup_steps", type=int, default=1000,
                       help="Warmup steps")
    return parser


def add_common_data_args(parser):
    g = parser.add_argument_group("Data (common)")
    g.add_argument("--resolution", type=int, default=512,
                   help="Image resolution")
    g.add_argument("--feedforward_resolution", type=int, default=448,
                   help="Image resolution for feedforward model")
    return parser


def add_training_data_args(parser):
    add_common_data_args(parser)
    g = parser.add_argument_group("Data (training)")
    g.add_argument("--batch_size", type=int, default=1,
                   help="Batch size for training")
    g.add_argument("--dataset", action="append", type=parse_dataset,
                   metavar="NAME:ROOT",
                   help=_dedent("""
                       Provide one or several datasets as NAME:ROOT.
                       Example:
                         --dataset dl3dv:/data/dl3dv \
                         --dataset other:/mnt/other_ds
                       """))
    g.add_argument("--num_frames_per_unit_scene", type=int, default=13,
                   help="Unit-scene window length in frames")
    g.add_argument("--num_images_from_unit_scene", type=int, default=13,
                   help="Images sampled per unit scene")
    return parser


def add_eval_data_args(parser):
    add_common_data_args(parser)
    g = parser.add_argument_group("Data (evaluation)")
    g.add_argument("--dataset", type=parse_dataset, action="append",
                   metavar="NAME:ROOT", required=True,
                   help="Provide a dataset as NAME:ROOT, e.g. re10k:/data")
    g.add_argument("--seq_id_map", type=str, required=True,
                   help="JSON mapping sequence names to eval frame IDs")
    return parser


def add_stitching_args(parser):
    g = parser.add_argument_group("Stitching")
    g.add_argument("--stitching_layer_location", type=str,
                   default="enc_blocks_2",
                   help="Location of the stitching layer")
    g.add_argument("--initialization_weight_path", type=str, default=None,
                   help="Init weight for the stitching layer")
    g.add_argument("--stitching_layer_config", type=parse_conv_spec,
                   default="conv3d_k5x3x3_o1024_s1x2x2_p2x1x1",
                   metavar="CONV_SPEC",
                   help="conv{1,2,3}d_k..._o..._s..._p..._d... grammar")
    g.add_argument("--lora_config", type=str, default="r8,a16,d0.05,f0",
                   help=_dedent("""
                       LoRA config.
                       r<rank>,a<alpha>,d<dropout>,b<bias>,t<targets>,f<0/1>
                       Examples:
                         r4,a16,d0.05
                         r8,a32,tq_proj|k_proj|v_proj
                       """))
    return parser


def add_mesh_args(parser, *, dit: bool = False,
                  default_dit_sharding: str = "fsdp"):
    """Device-mesh layout.  The reference launches multi-device by
    construction (torchrun DDP `model_stitching_training.py:286-289`,
    accelerate FSDP2 `train_vdm.py:296-310`); `core/mesh.py` lays one 2-D
    `(data, model)` mesh over the launch's ranks.  `dit=True` adds the DiT
    placement choice (`core/mesh.py::place_dit`)."""
    g = parser.add_argument_group("Mesh / parallelism")
    g.add_argument("--mesh_data", type=int, default=-1,
                   help="Devices on the data axis (-1: all / mesh_model)")
    g.add_argument("--mesh_model", type=int, default=1,
                   help="Devices on the model (tensor-parallel) axis")
    if dit:
        g.add_argument("--dit_sharding", type=str,
                       default=default_dit_sharding,
                       choices=["fsdp", "tp", "tp_fsdp", "replicated"],
                       help="DiT parameter placement over the mesh "
                            "(tp_fsdp: TP over 'model' + FSDP storage over "
                            "'data' — the 14B training placement)")
    return parser


# --------------------------------------------------------------------------- #
# parser builders                                                             #
# --------------------------------------------------------------------------- #
def stitching_training_argument() -> argparse.ArgumentParser:
    parser = make_parser("Stitching training argument")
    add_model_selection_args(parser)
    add_run_and_logging_args(parser)
    add_training_loop_args(parser)
    add_optimizer_args(parser, include_warmup=True)
    add_training_data_args(parser)
    add_stitching_args(parser)
    add_mesh_args(parser)
    return parser


def find_layer_stitching_argument() -> argparse.ArgumentParser:
    parser = make_parser("Find layer for stitching argument")
    g = parser.add_argument_group("Feature extraction")
    g.add_argument("--feature_save_path", type=str, required=True,
                   help="Path to save features for the stitching search")
    g.add_argument("--iterations_for_feature_extraction", type=int,
                   default=100,
                   help="Total data = batch_size x iterations")
    add_model_selection_args(parser)
    add_training_data_args(parser)
    add_stitching_args(parser)
    return parser


def stitching_nvs_evaluation_argument() -> argparse.ArgumentParser:
    parser = make_parser("Stitching NVS evaluation argument")
    add_model_selection_args(parser)
    add_stitching_args(parser)
    add_eval_data_args(parser)
    g = parser.add_argument_group("Evaluation")
    g.add_argument("--checkpoint_path", type=str,
                   help="Path to the trained stitching model")
    g.add_argument("--output_dir", type=str,
                   default="nvs_evaluation_results",
                   help="Path to save evaluation results")
    return parser


def training_vdm_argument() -> argparse.ArgumentParser:
    parser = make_parser("Training VDM argument")
    add_run_and_logging_args(parser)
    add_training_loop_args(parser)
    add_model_selection_args(parser)
    add_stitching_args(parser)
    add_optimizer_args(parser, include_warmup=False)
    add_training_data_args(parser)
    g = parser.add_argument_group("VDM")
    g.add_argument("--text_dataset_path", type=str,
                   help="Path to text dataset for VDM training")
    g.add_argument("--checkpoint_path", type=str,
                   help="Path to the trained stitching checkpoint")
    g.add_argument("--qual_coeff", default=0.25, type=float,
                   help="Quality-score coefficient in the reward")
    g.add_argument("--mse_coeff", default=1.0, type=float,
                   help="MSE coefficient in the reward")
    g.add_argument("--model_id", default="Wan-AI/Wan2.1-T2V-1.3B-Diffusers",
                   type=str)
    g.add_argument("--save_freq", default=100, type=int,
                   help="Checkpoint save frequency (steps)")
    g.add_argument("--enable_rl", action=argparse.BooleanOptionalAction,
                   default=False, help="Enable rl")
    add_mesh_args(parser, dit=True)
    parser.set_defaults(num_frames_per_unit_scene=32)
    return parser


def inference_vist3a_argument() -> argparse.ArgumentParser:
    parser = make_parser("Inference on VIST3A argument")
    add_model_selection_args(parser)
    add_stitching_args(parser)
    add_common_data_args(parser)
    # the JAX package's default: 14B runs tensor-parallel on a TPU mesh
    add_mesh_args(parser, dit=True, default_dit_sharding="tp")
    g = parser.add_argument_group("Inference")
    g.add_argument("--model_id", default="Wan-AI/Wan2.1-T2V-1.3B-Diffusers",
                   type=str)
    g.add_argument("--checkpoint_path", type=str, required=True,
                   help="Path to the trained stitching model")
    g.add_argument("--transformer_lora_path", type=str, required=True,
                   help="Path to the LoRA weights for the transformer")
    g.add_argument("--input_texts_path", type=str, required=True,
                   help="Path to input texts for inference")
    g.add_argument("--output_dir", type=str,
                   default="inference_vist3a_results",
                   help="Path to save inference results")
    # the port's one flag beyond the JAX parser's: where the released
    # weights lie (`cli/model_loading.py`; else $VIST3A_WEIGHTS)
    g.add_argument("--weights_root", type=str, default=None,
                   help="Folder of anysplat.pth, wan_vae/, wan_dit/, umt5/")
    g.add_argument("--num_frames", type=int, default=13,
                   help="Frames to generate per input text")
    g.add_argument("--flow_shift", type=float, default=5,
                   help="Flow shift value for timesteps")
    g.add_argument("--cfg_scale", type=str, default="7.5",
                   help="CFG scale(s), single or comma-separated")
    return parser


def validate_vdm_args(parser, args) -> None:
    """`utils/argument.py:451-463`."""
    if getattr(args, "num_frames_per_unit_scene", None) != 32:
        parser.error("--num_frames_per_unit_scene must be 32 for VDM "
                     "training")
