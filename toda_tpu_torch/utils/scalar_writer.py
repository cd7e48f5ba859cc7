"""Training-scalar writer (the reference's tensorboardX ``SummaryWriter``
surface).

The port's own copy of ``toda_tpu/utils/scalar_writer.py``: TensorBoard
event files through ``torch.utils.tensorboard`` when the tensorboard
package is importable, otherwise an append-only ``scalars.jsonl`` in the
same directory. Construct it on rank 0 only.
"""

import json
import time
from pathlib import Path


class JsonlScalarWriter:
    def __init__(self, log_dir):
        self.path = Path(log_dir) / "scalars.jsonl"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._f = open(self.path, "a", buffering=1)

    def add_scalar(self, tag, value, step):
        self._f.write(json.dumps({"tag": tag, "value": float(value), "step": int(step),
                                  "wall_time": time.time()}) + "\n")

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


def create_scalar_writer(log_dir):
    """An object with add_scalar(tag, value, step), flush() and close()."""
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(log_dir=str(log_dir))
    except ImportError:
        return JsonlScalarWriter(log_dir)
