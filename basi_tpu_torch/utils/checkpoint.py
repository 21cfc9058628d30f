"""Checkpoints of the whole train state, and resume (port of
``basi_tpu/utils/checkpoint.py``).

The JAX package saves with orbax, which needs jax; the port writes torch
files. A checkpoint is one directory per saved step, ``<dir>/<step>/``,
holding ``state.pt``: the model's state dict (f32 master params and the
BatchNorm running statistics), the SGD momentum (the optimizer's state
dict), the EMA of the params (or None), the step and the flip generator's
state. A save writes into a directory whose name is unique to its writer
(``.tmp-<step>-*``), syncs the file, then moves the directory into place
with ``os.replace``: a crash never leaves a half-written step under a step
number, and ``latest_step`` counts only step directories that hold the
file. The newest ``keep`` steps are kept. Reads go through
``torch.load(weights_only=True)``.

``export_params`` / ``load_params`` write and read the serving export, the
counterpart of the JAX package's bare params directory: ``<dir>/params.pt``
holds the model's state dict (f32 params and the BatchNorm running
statistics) and nothing of the train state.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import torch

FORMAT = "basi-torch-train-state-v1"
STATE_FILE = "state.pt"
PARAMS_FORMAT = "basi-torch-params-v1"
PARAMS_FILE = "params.pt"


def _write_synced(path: str, payload) -> None:
    """``torch.save`` into ``path``'s directory under a unique name, synced,
    then renamed over ``path``."""
    fd, tmp = tempfile.mkstemp(prefix=".tmp-", dir=os.path.dirname(path))
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False):
        """``directory`` is made by the first ``save``, not here, so that a
        reader given a wrong path leaves nothing behind."""
        if async_save:
            raise NotImplementedError("train.async_checkpoint not yet ported")
        self.directory = os.path.abspath(directory)
        self.keep = keep

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step), STATE_FILE)

    def steps(self) -> list[int]:
        """The complete saved steps, oldest first."""
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isfile(self._path(int(d))))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, state) -> None:
        """Commit ``state`` (a ``train.state.TrainState``) at its step;
        a step already saved raises ``FileExistsError``."""
        step = int(state.step)
        final = os.path.join(self.directory, str(step))
        if os.path.exists(final):
            raise FileExistsError(f"checkpoint step {step} exists in "
                                  f"{self.directory}")
        payload = {
            "format": FORMAT,
            "step": step,
            "model": {k: v.detach()
                      for k, v in state.model.state_dict().items()},
            "optimizer": state.optimizer.state_dict(),
            "ema": state.ema,
            "generator": state.generator.get_state(),
        }
        os.makedirs(self.directory, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=f".tmp-{step}-", dir=self.directory)
        try:
            with open(os.path.join(tmp, STATE_FILE), "wb") as f:
                torch.save(payload, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        fd = os.open(self.directory, os.O_RDONLY)
        try:  # the rename itself durable
            os.fsync(fd)
        finally:
            os.close(fd)
        if self.keep > 0:
            for old in self.steps()[:-self.keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)),
                              ignore_errors=True)

    def load(self, step: int | None = None) -> dict:
        """The raw contents of ``step`` (default: the newest), tensors on
        the CPU."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        path = self._path(step)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"no checkpoint step {step} in "
                                    f"{self.directory}")
        raw = torch.load(path, map_location="cpu", weights_only=True)
        if raw.get("format") != FORMAT:
            raise ValueError(f"{path}: unsupported checkpoint format "
                             f"{raw.get('format')!r} (want {FORMAT})")
        return raw

    def restore(self, state, step: int | None = None):
        """Load ``step`` (default: the newest) into ``state`` in place and
        return it. The optimizer keeps its configured hyperparameters and
        takes the saved momentum. An EMA turned on since the save starts
        at the restored params; one turned off is dropped."""
        raw = self.load(step)
        state.model.load_state_dict(raw["model"], strict=True)
        opt = state.optimizer
        hyper = [{k: v for k, v in g.items() if k != "params"}
                 for g in opt.param_groups]
        opt.load_state_dict(raw["optimizer"])
        for group, h in zip(opt.param_groups, hyper):
            group.update(h)
        if state.ema is not None:
            if raw["ema"] is None:
                state.ema = {k: p.detach().clone()
                             for k, p in state.model.named_parameters()}
            else:
                if set(raw["ema"]) != set(state.ema):
                    raise ValueError("checkpoint EMA keys differ from the "
                                     "model's params")
                with torch.no_grad():
                    for k, v in raw["ema"].items():
                        state.ema[k].copy_(v)
        state.step = int(raw["step"])
        state.generator.set_state(raw["generator"])
        return state

    def restore_weights(self, step: int | None = None) -> dict:
        """The eval weights of ``step`` (default: the newest) as the
        model's state dict, the EMA in the params' places when the
        checkpoint has one, with the BatchNorm running statistics. Needs
        no train state, so any training configuration's checkpoint
        loads."""
        raw = self.load(step)
        sd = dict(raw["model"])
        if raw["ema"]:
            sd.update(raw["ema"])
        return sd

    def maybe_resume(self, state, resume: str = "auto"):
        """``resume``: ``auto`` (the newest step here, else ``state`` as it
        is), ``none``, a step number in this directory, or another
        checkpoint directory (its newest step)."""
        if resume == "none":
            return state
        if resume == "auto":
            if self.latest_step() is None:
                return state
            return self.restore(state)
        if resume.isdigit():
            return self.restore(state, int(resume))
        if not os.path.isdir(resume):
            raise FileNotFoundError(
                f"resume: no checkpoint directory at {resume!r}")
        return CheckpointManager(resume).restore(state)


def export_params(path: str, state_dict: dict) -> None:
    """Write the serving export of ``state_dict`` (the model's: params and
    BatchNorm statistics) into directory ``path``. Every floating tensor
    must be float32: an export keeps the f32 masters, whatever the
    inference dtype."""
    low = sorted(k for k, v in state_dict.items()
                 if v.is_floating_point() and v.dtype != torch.float32)
    if low:
        raise ValueError(f"export_params keeps f32 weights; {len(low)} "
                         f"tensors are not float32, e.g. {low[:3]}")
    os.makedirs(path, exist_ok=True)
    _write_synced(os.path.join(path, PARAMS_FILE), {
        "format": PARAMS_FORMAT,
        "model": {k: v.detach().cpu() for k, v in state_dict.items()}})


def is_params_export(path: str) -> bool:
    return os.path.isfile(os.path.join(path, PARAMS_FILE))


def load_params(path: str) -> dict:
    """The state dict of an ``export_params`` directory, on the CPU."""
    file = os.path.join(path, PARAMS_FILE)
    if not os.path.isfile(file):
        raise FileNotFoundError(f"no params export at {path!r}")
    raw = torch.load(file, map_location="cpu", weights_only=True)
    if raw.get("format") != PARAMS_FORMAT:
        raise ValueError(f"{file}: unsupported params format "
                         f"{raw.get('format')!r} (want {PARAMS_FORMAT})")
    return raw["model"]
