"""``python -m ant_ray_tpu_torch`` — the operator CLI (see cli.py)."""

from ant_ray_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
