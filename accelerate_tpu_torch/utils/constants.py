"""Shared constants: the port of `accelerate_tpu.utils.constants` (the
reference's `src/accelerate/utils/constants.py` roles: checkpoint file
names, option lists). `checkpointing` names its files from here."""

# checkpoint layout (see checkpointing.py)
MODEL_NAME = "model"
OPTIMIZER_NAME = "optimizer"
SCHEDULER_NAME = "scheduler"
SAMPLER_NAME = "sampler"
DATALOADER_STATE_NAME = "dataloader"
RNG_STATE_NAME = "rng_state"
CUSTOM_STATE_NAME = "custom_checkpoint"
STEP_STATE_NAME = "step"
CHECKPOINT_DIR_PREFIX = "checkpoint"
# the commit marker, written only after every file of a checkpoint has
# landed on disk; its absence marks a crashed or in-flight save
CHECKPOINT_COMPLETE_MARKER = "_COMPLETE"

# a profile trace's file name pattern (one per process)
PROFILE_PATTERN_NAME = "profile_{suffix}"

# mesh axis names, outermost to innermost (the multi-device runtime, ROADMAP
# Queue 1, item 21.3, lays meshes out over them)
MESH_AXIS_NAMES = ("data", "fsdp", "stage", "sequence", "tensor")

# the environment variables' namespace (launcher <-> library contract)
ENV_PREFIX = "ACCELERATE_TPU_"

# the default config file's location
DEFAULT_CONFIG_DIR_ENV = "ACCELERATE_TPU_CONFIG_DIR"
DEFAULT_CONFIG_NAME = "default_config.yaml"

FSDP_STATE_DICT_TYPES = ["FULL_STATE_DICT", "SHARDED_STATE_DICT"]

MIXED_PRECISION_CHOICES = ["no", "bf16", "fp16", "fp8"]
