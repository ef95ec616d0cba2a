"""Command-line entry points of the port (counterpart of helicon_tpu/commands)."""


def command_device(name: str):
    """The torch device of a command's ``--device`` (cuda = the card). A card
    that is not there raises: the command never carries on on the CPU."""
    import torch

    from ..utils.exceptions import HeliconError

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise HeliconError(f"--device {name}: no CUDA device (pass --device cpu to run "
                           "on the CPU)")
    return device
