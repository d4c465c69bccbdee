from .optimizer import make_optimizer, make_schedule, param_label, trainability_mask
from .checkpoint import save_checkpoint, load_checkpoint
from .trainer import Trainer
