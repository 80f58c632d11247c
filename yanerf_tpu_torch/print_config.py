"""Resolve and pretty-print a config (counterpart of ``scripts/print_config.py``).

    python -m yanerf_tpu_torch.print_config configs/nerf/lego_proposal.yml [--cfg_options k=v ...]
"""

from __future__ import annotations

import argparse

from .utils.config import Config, DictAction


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="Print the resolved config")
    parser.add_argument("config", help="config file path")
    parser.add_argument("--save_path", default=None, help="optionally dump the resolved config here")
    parser.add_argument("--cfg_options", nargs="+", action=DictAction,
                        help="override settings in the config via key=value pairs")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    if args.cfg_options is not None:
        cfg.merge_from_dict(args.cfg_options)
    print(f"Config:\n{cfg.pretty_text}")
    if args.save_path is not None:
        cfg.dump(args.save_path)
        print(f"Saved to {args.save_path}")


if __name__ == "__main__":
    main()
