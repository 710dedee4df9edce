"""Compatibility alias (counterpart of cli/lightning.py): the reference's
`python -m cli.lightning` (pytorch-lightning DDP trainer,
cli/lightning.py:28-362) maps to `edgedict_tpu_torch.cli.distributed`,
which takes the same flags."""

from edgedict_tpu_torch.cli.distributed import main  # noqa: F401

if __name__ == '__main__':
    main()
