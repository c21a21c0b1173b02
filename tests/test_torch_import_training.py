"""The port's training path runs with JAX, Flax, Optax and the JAX package
blocked: the training modules import, the four synthetic batch functions
run at a size under 224 px, one Trainer step runs on the CPU, and the
copied evaluation helpers work."""

import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

CODE = """
import sys
for m in ('jax', 'jaxlib', 'flax', 'optax', 'sbb_textline_detection_tpu'):
    sys.modules[m] = None
import numpy as np
import torch
from sbb_textline_detection_tpu_torch.models import registry
from sbb_textline_detection_tpu_torch.training import cli, data, eval, train
from sbb_textline_detection_tpu_torch.utils import synthetic

for role, fn in sorted(synthetic.BATCH_FNS.items()):
    imgs, labels = fn(np.random.default_rng(0), 2, 64, 64)
    assert imgs.shape[:3] == (2, 64, 64) and labels.dtype == np.int32, role
imgs, labels = next(data.synthetic_batches('dualhead', 2, 32, 32, seed=1))
spec = registry.ModelSpec('t', 'tpu_unet', 32, 32, 5, widths=(8, 16),
                          heads=(3, 2), in_channels=2)
tr = train.Trainer(spec, seed=0, device=torch.device('cpu'))
assert np.isfinite(tr.train(iter([(imgs, labels)]), 1)[0])
pred = np.array([[0, 1], [1, 1]])
assert eval.mean_iou(pred, pred, 2) == 1.0
assert 'jax' not in [m for m, v in sys.modules.items() if v is not None]
print('ok')
"""


def test_training_path_runs_with_jax_blocked():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", CODE], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
