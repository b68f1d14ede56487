from repro_torch.train.step import make_train_step, make_eval_step  # noqa: F401
from repro_torch.train.loop import LoopConfig, StragglerMonitor, TrainLoop  # noqa: F401
from repro_torch.train import checkpoint  # noqa: F401
