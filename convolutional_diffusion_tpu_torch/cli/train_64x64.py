"""64x64 training CLI. Counterpart of
`convolutional_diffusion_tpu/cli/train_64x64.py` (the reference's
`scripts/training_script_64x64.py`): the same recipe at 64x64 (UNet fsizes
[64, 128, 256, 512][:layers], default mode zeros, batch 64, at most 4
layers; the ResNet unchanged). Checkpoint names carry the _64x64 marker.
Runs on cuda; --cpu runs on the CPU instead; --ndevices as `cli.train`.
"""

import os

from .common import spawn_ranks
from .train import parse_train_args, run, subset


def main(argv=None):
    args = parse_train_args(argv, description="DDIM training 64x64", batchsize=64,
                            dataset="celeba", mode="zeros", layers=4,
                            homedir="./checkpoints")
    args.layers = min(args.layers, 4)  # reference caps at 4 (64 -> 8 pools)
    spawned, result = spawn_ranks(__spec__.name, argv, args.ndevices, cpu=args.cpu,
                                  zero_is_all=True)
    if spawned:
        return result

    from ..data import get_dataset
    from ..models import MinimalResNet, MinimalUNet

    ds, metadata = get_dataset(args.dataset, root=args.dataroot, image_size=64)
    ds, _, factor = subset(ds, args.maxsamps)
    normal = None if args.nonorm else "GroupNorm"
    common = dict(channels=metadata["num_channels"], mode=args.mode,
                  conditional=args.conditional, num_classes=metadata["num_classes"],
                  normalization=normal, lastksize=3)
    if args.resnet:
        backbone = MinimalResNet(emb_dim=128 * args.mult, kernel_size=3,
                                 num_layers=args.layers, **common)
        model_tag = "ResNet"
    else:
        backbone = MinimalUNet(fsizes=tuple([64, 128, 256, 512][: args.layers]), **common)
        model_tag = "UNet"
    # reference naming: backbone_{DS}_{Model}_{mode}_64x64... (script :84-98)
    fname = f"backbone_{metadata['name']}_{model_tag}_{args.mode}_64x64"
    if args.conditional:
        fname += "_conditional"
    return run(args, backbone, ds, factor, os.path.join(args.homedir, fname), 64)


if __name__ == "__main__":
    main()
