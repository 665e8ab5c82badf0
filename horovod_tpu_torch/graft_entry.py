"""Entry points of the port: the counterpart of ``__graft_entry__.py``.

- :func:`entry` — the ResNet-50 eval forward (the headline model) with
  example arguments, on the card unless ``device="cpu"``.

``dryrun_multichip`` (the dp×sp×tp×ep train step over n ranks) comes
with the process-group layer (ROADMAP Queue A item 13).
"""

import torch

from .device import resolve_device
from .models import resnet


def entry(device=None):
    """Return ``(fn, example_args)``: ``fn(model, images)`` is the
    ResNet-50 eval forward (1000 classes, random weights from seed 0)
    and ``images`` are ``8×128×128×3`` float32 ones; ``fn(*args)`` gives
    float32 logits ``[8, 1000]``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    model = resnet.create_train_state(gen, image_size=128, num_classes=1000,
                                      device=device)
    images = torch.ones((8, 128, 128, 3), device=device)

    def fwd(model, images):
        with torch.no_grad():
            return model(images, train=False)

    return fwd, (model, images)
