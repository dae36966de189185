"""python -m core_tpu_torch scene.xml [output] [flags]: see cli.py."""
from core_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
