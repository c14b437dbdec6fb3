"""Dataset downloads from S3 (a copy of tools/download_dataset.py; parity:
datasets/download/*).

`python -m mvsnet_tpu_torch.tools.download_dataset <dataset> <output_dir>`

Needs boto3 and AWS credentials. boto3 is imported inside `download`:
without it the tool prints the `aws s3 sync` command that fetches the same
objects and returns 1.
"""

from __future__ import annotations

import argparse
import os

# Known dataset prefixes (parity: datasets/download/constants.py; the U6
# training buckets and the 7-Scenes splits).
DATASETS = {
    "mvs-training": ("u6-mvs-datasets", "mvs-training/"),
    "7scenes-train": ("u6-mvs-datasets", "7scenes/train/"),
    "7scenes-test": ("u6-mvs-datasets", "7scenes/test/"),
}


def download(dataset: str, output_dir: str) -> int:
    """Sync `dataset`'s objects into `output_dir`: 0 when done, 1 without
    boto3 (after printing the `aws s3 sync` command), 2 for an unknown
    dataset."""
    if dataset not in DATASETS:
        print(f"unknown dataset {dataset!r}; options: {sorted(DATASETS)}")
        return 2
    bucket, prefix = DATASETS[dataset]
    try:
        import boto3  # noqa: PLC0415
    except ImportError:
        print("boto3 is not installed in this environment. To download manually:")
        print(f"  aws s3 sync s3://{bucket}/{prefix} {output_dir}")
        return 1
    s3 = boto3.resource("s3")
    b = s3.Bucket(bucket)
    os.makedirs(output_dir, exist_ok=True)
    n = 0
    for obj in b.objects.filter(Prefix=prefix):
        rel = obj.key[len(prefix):]
        if not rel:
            continue
        dst = os.path.join(output_dir, rel)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        b.download_file(obj.key, dst)
        n += 1
        if n % 100 == 0:
            print(f"downloaded {n} objects")
    print(f"downloaded {n} objects to {output_dir}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("dataset", choices=sorted(DATASETS))
    p.add_argument("output_dir")
    args = p.parse_args(argv)
    return download(args.dataset, args.output_dir)


if __name__ == "__main__":
    raise SystemExit(main())
