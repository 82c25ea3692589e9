"""Program fingerprints that hold across processes.

``program_fingerprint`` keys the compiled cache and the model registry,
whose ``REGISTRY_MANIFEST.json`` a relaunched process re-adopts.  Built
from Python's ``hash`` of strings it was salted per process
(``PYTHONHASHSEED``), so a manifest failed re-adoption in the next
process with ``ManifestMismatchError``; it is a keyed BLAKE2b digest
now.  Two child processes with different hash seeds load one saved
1-layer LM on the CPU: they agree on the Predictor's fingerprint, on the
saved program's and on ``registry._dir_fingerprint``, and the second
re-adopts the manifest that the first wrote.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_port_helpers  # noqa: F401  (caps torch's threads)
from torch_port_helpers import fresh_port_programs

import paddle_tpu_torch as pt
from paddle_tpu_torch.core import compiler
from paddle_tpu_torch.core.program import Program as PortProgram
from paddle_tpu_torch.models.transformer import transformer_encoder_model

LM = dict(vocab_size=64, max_len=8, d_model=16, n_head=2, d_inner=32,
          n_layer=1, dropout_rate=0.0, is_test=True)

# run by each child: the fingerprints of one saved LM, then the registry
# (the first child registers the model and writes the manifest, the
# second re-adopts it)
CHILD = r"""
import json, sys
from paddle_tpu_torch import inference, serving
from paddle_tpu_torch.serving import registry
model_dir, root, register = sys.argv[1], sys.argv[2], sys.argv[3] == "1"
cfg = inference.Config(model_dir)
cfg.disable_gpu()
pred = inference.create_predictor(cfg)
reg = serving.ModelRegistry(root=root)
if register:
    reg.register("lm", model_dir)
    reg.save()
print(json.dumps({
    "predictor": pred.program_fingerprint(),
    "dir": registry._dir_fingerprint(model_dir),
    "adopted": reg.adopted,
    "versions": [v.fingerprint for v in reg.versions("lm")],
}))
"""


def _save_lm(dirname):
    with fresh_port_programs():
        model = transformer_encoder_model(**LM)
        exe = pt.Executor(pt.CPUPlace())
        np.random.seed(0)
        exe.run(pt.default_startup_program())
        d = os.path.join(str(dirname), "lm")
        pt.io.save_inference_model(d, ["src_ids"], [model["logits"]], exe)
    return d


def _child(hash_seed, model_dir, root, register):
    env = dict(os.environ, PYTHONHASHSEED=str(hash_seed),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, model_dir, root,
         "1" if register else "0"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_fingerprints_hold_across_hash_seeds_and_manifest_readopts(
        tmp_path):
    d = _save_lm(tmp_path)
    root = str(tmp_path / "registry")
    first = _child(1, d, root, register=True)
    second = _child(2, d, root, register=False)
    assert first["adopted"] == 0 and second["adopted"] == 1
    for key in ("predictor", "dir", "versions"):
        assert first[key] == second[key], key
    assert first["versions"] == [first["dir"]]
    # this process (its own hash seed) agrees with both
    from paddle_tpu_torch.serving import registry

    assert registry._dir_fingerprint(d) == first["dir"]
    with open(os.path.join(d, "__model__")) as f:
        saved = PortProgram.from_dict(json.load(f)["program"])
    assert compiler.program_fingerprint(saved) == first["dir"]


def _digest(v):
    import hashlib

    h = hashlib.blake2b(digest_size=8)
    compiler._fp_encode(h, v)
    return h.hexdigest()


ARRAY = np.arange(6, dtype=np.float32).reshape(2, 3)


@pytest.mark.parametrize("a, b, same", [
    (1, 1.0, True), (1, True, True), (0, False, True),
    ([1, "a"], (1, "a"), True), (np.float32(0.5), 0.5, True),
    (np.int64(3), 3, True), (0.5, 1, False), ("1", 1, False),
    (None, 0, False), ("ab", ("a", "b"), False), ([], None, False),
    (2.5, np.float64(2.5), True), (0.1, 0.30000000000000004 - 0.2, False),
    (("__nd__", ARRAY.shape, str(ARRAY.dtype), ARRAY.tobytes()),
     ("__nd__", (3, 2), "float32", ARRAY.tobytes()), False),
])
def test_fingerprint_encoding_is_deterministic(a, b, same):
    """Each canonical value has one encoding, so one digest in every
    process; numbers that compare equal encode alike (as they hashed
    alike under ``hash``), a list and a tuple too."""
    assert _digest(a) == _digest(a)
    assert (_digest(a) == _digest(b)) is same


def test_fingerprint_refuses_values_it_cannot_encode():
    with pytest.raises(TypeError, match="no deterministic encoding"):
        _digest(object())
