"""Filelist writer CLI of the port (counterpart of ``mft_tpu/cli/make_filelists.py``)
— the offline prep step of reference ``filelists/``.

Examples:
  python -m mft_tpu_torch.cli.make_filelists --mode index_split \
      --data_root CUB_200_2011/images --out filelists/CUB
  python -m mft_tpu_torch.cli.make_filelists --mode csv_split \
      --data_root images --csv_dir ravi_splits --out filelists/miniImagenet
  python -m mft_tpu_torch.cli.make_filelists --mode cross \
      --data_root miniImagenet/images --cub_root CUB/images --out filelists/cross
"""

from __future__ import annotations

import argparse
import sys

from mft_tpu_torch.data import filelists


def main(argv=None):
    p = argparse.ArgumentParser(description="write base/val/novel.json filelists")
    p.add_argument("--mode", choices=["index_split", "csv_split", "cross"], default="index_split")
    p.add_argument("--data_root", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--csv_dir", default=None, help="Ravi split CSV dir (csv_split mode)")
    p.add_argument("--cub_root", default=None, help="CUB image root (cross mode)")
    a = p.parse_args(argv)
    if a.mode == "index_split":
        filelists.write_index_split_filelists(a.data_root, a.out)
    elif a.mode == "csv_split":
        if not a.csv_dir:
            p.error("--csv_dir required for csv_split")
        filelists.write_csv_split_filelists(a.data_root, a.out, a.csv_dir)
    else:
        if not a.cub_root:
            p.error("--cub_root required for cross")
        filelists.write_cross_filelists(a.data_root, a.cub_root, a.out)


if __name__ == "__main__":
    main(sys.argv[1:])
