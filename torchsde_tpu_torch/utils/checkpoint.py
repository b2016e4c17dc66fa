"""Checkpoint and resume (counterpart of ``torchsde_tpu/utils/checkpoint.py``).

A checkpoint is one ``torch.save`` file of named entries: the
``state_dict`` of each module and optimizer, the state of each
``torch.Generator``, and plain values (a step counter, a float). Loading
writes the entries back into the objects given under the same names, so a
run that saves at step k, loads and continues takes the same steps, bit for
bit, as the run that never stopped::

    save_checkpoint("ck.pt", model=model, opt=opt, gen=gen, step=k)
    values = load_checkpoint("ck.pt", "cuda", model=model, opt=opt, gen=gen)
    k = values["step"]
"""

import os

import torch

_KINDS = ("state_dict", "generator", "value")


def save_checkpoint(path, **entries):
    """Save ``entries`` (name -> module, optimizer, generator or plain
    value) to ``path``; returns the absolute path."""
    path = os.path.abspath(path)
    state = {}
    for name, obj in entries.items():
        if isinstance(obj, torch.Generator):
            state[name] = ("generator", obj.get_state())
        elif hasattr(obj, "state_dict"):
            state[name] = ("state_dict", obj.state_dict())
        else:
            state[name] = ("value", obj)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(state, path)
    return path


def load_checkpoint(path, map_location, **entries):
    """Load the checkpoint at ``path`` into ``entries`` (name -> module,
    optimizer or generator), in place. ``map_location`` is the device its
    tensors go to (``"cpu"``, ``"cuda"``): it is required, so that a
    checkpoint written on the card loads on the CPU only when asked. A
    generator's state is a CPU byte tensor whatever its device. Raises
    ``KeyError`` when a name given has no entry, or names an entry of
    another kind. Returns ``{name: value}`` of every plain value saved."""
    state = torch.load(path, map_location=map_location, weights_only=True)
    for name, obj in entries.items():
        if name not in state:
            raise KeyError(f"checkpoint {path} has no entry {name!r} (it "
                           f"has {sorted(state)})")
        kind, saved = state[name]
        want = ("generator" if isinstance(obj, torch.Generator)
                else "state_dict")
        if kind != want:
            raise KeyError(f"checkpoint entry {name!r} is a {kind}, not a "
                           f"{want}")
        if kind == "generator":
            obj.set_state(saved.cpu())
        else:
            obj.load_state_dict(saved)
    return {name: saved for name, (kind, saved) in state.items()
            if kind == "value"}
