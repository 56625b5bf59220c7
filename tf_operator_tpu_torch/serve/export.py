"""Export a training checkpoint as a quantized serving artifact: the
port's copy of tf_operator_tpu/serve/export.py.

A training checkpoint (train/trainer.py Checkpointer: the model's state
dict and the optimizer's) carries optimizer moments the server never
reads and f32 kernels the decode path would re-quantize on every cold
start. This export restores the newest step, keeps only the model's
weights, quantizes its projection kernels to int8 with one f32 scale per
feature slice (ops/quant.py `quantize_model`: the exact twin
``--weights-int8`` builds at load) and writes that twin's state dict:
the server loads it with no transform work.

    python -m tf_operator_tpu_torch.serve.export \\
        --preset small --checkpoint-dir /ckpt/gpt --out /ckpt/gpt-int8
    python -m tf_operator_tpu_torch.serve --preset small \\
        --checkpoint-dir /ckpt/gpt-int8        # layout auto-detected

The artifact is the port's own format (`params.pt`, a torch.save of the
int8 twin's state dict, beside `export.json`), as the port's checkpoints
are its own and not orbax's; the manifest's keys are the reference's.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

logger = logging.getLogger("tf_operator_tpu_torch.serve.export")

MANIFEST = "export.json"
PARAMS_FILE = "params.pt"


def is_exported_dir(directory: str) -> bool:
    return os.path.isfile(os.path.join(directory, MANIFEST))


def load_exported(directory: str):
    """(the int8 twin's state dict on the CPU, manifest dict) from an
    exported serving directory."""
    import torch

    with open(os.path.join(directory, MANIFEST)) as handle:
        manifest = json.load(handle)
    state = torch.load(os.path.join(directory, PARAMS_FILE), map_location="cpu",
                       weights_only=True)
    return state, manifest


def _state_bytes(state) -> int:
    return sum(t.numel() * t.element_size() for t in state.values())


def export(trainer_state_restore, out: str, preset: str) -> dict:
    """Quantize + write; returns the manifest. trainer_state_restore is a
    callable returning (the model's f32 state dict, step), injected so
    tests can skip the checkpoint dance; the preset names the GPT config
    the state belongs to and is stamped for the server's mismatch check."""
    import torch

    from ..models import gpt as gpt_lib
    from ..ops.quant import quantize_model

    state, step = trainer_state_restore()
    state = {name: t.detach().to("cpu") for name, t in state.items()}
    with torch.device("meta"):
        model = gpt_lib.GPT(gpt_lib.GPT_PRESETS[preset])
    model.load_state_dict(state, assign=True)
    quantized = {name: t.contiguous() for name, t in quantize_model(model).state_dict().items()}
    os.makedirs(out, exist_ok=True)
    # written under a temporary name, then renamed: a reader never sees
    # half an artifact
    path = os.path.join(out, PARAMS_FILE)
    torch.save(quantized, path + ".tmp")
    os.replace(path + ".tmp", path)
    manifest = {
        "quantized": True,
        "preset": preset,
        "step": int(step),
        "params_bytes": _state_bytes(quantized),
        "source_params_bytes": _state_bytes(state),
        "tool": "tf_operator_tpu_torch.serve.export",
    }
    with open(os.path.join(out, MANIFEST), "w") as handle:
        json.dump(manifest, handle, indent=1)
    logger.info(
        "exported step %d: %.1fMB -> %.1fMB params", manifest["step"],
        manifest["source_params_bytes"] / 1e6, manifest["params_bytes"] / 1e6,
    )
    return manifest


def exported_model(directory: str, preset: str, device):
    """The int8 twin an exported directory holds, on `device`, and its
    manifest. Refuses an artifact built for another preset (its shapes
    would fail per request otherwise)."""
    import torch

    from ..models import gpt as gpt_lib
    from ..ops.quant import quantize_model

    state, manifest = load_exported(directory)
    built_for = manifest.get("preset")
    if built_for and built_for != preset:
        raise SystemExit(
            f"exported artifact was built for --preset {built_for!r} but the server was "
            f"started with --preset {preset!r}"
        )
    # the twin's structure from a model built on `device` and overwritten by
    # the artifact's tensors. Not on the meta device: a process's first meta
    # build imports torch's compiler stack, seconds of a server's start
    with torch.device(device):
        twin = quantize_model(gpt_lib.GPT(gpt_lib.GPT_PRESETS[preset]))
    twin.load_state_dict(state)
    return twin, manifest


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m tf_operator_tpu_torch.serve.export")
    parser.add_argument("--preset", choices=["tiny", "small"], default="small")
    parser.add_argument("--checkpoint-dir", required=True)
    parser.add_argument("--out", required=True)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr)

    import torch

    from ..train.trainer import Checkpointer

    def restore():
        checkpointer = Checkpointer(args.checkpoint_dir)
        step = checkpointer.latest_step()
        if step is None:
            raise SystemExit(f"no checkpoint found in {args.checkpoint_dir}")
        payload = torch.load(checkpointer.path(step), map_location="cpu", weights_only=True)
        return payload["model"], step

    export(restore, args.out, args.preset)
    return 0


if __name__ == "__main__":
    sys.exit(main())
