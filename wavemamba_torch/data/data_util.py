"""Path-pairing utilities. The counterpart of the paired-path functions of
`wavemamba_tpu/data/data_util.py`; its lmdb and video helpers are not ported
(ROADMAP queue 1, item 11)."""

from __future__ import annotations

import os

from wavemamba_torch.utils.misc import scandir


def paired_paths_from_folder(folders, keys, filename_tmpl="{}"):
    """Pair the files of an LQ folder and a GT folder by stem."""
    input_folder, gt_folder = folders
    input_key, gt_key = keys
    input_paths = list(scandir(input_folder))
    gt_paths = list(scandir(gt_folder))
    if len(input_paths) != len(gt_paths):
        raise ValueError(f"{input_key} and {gt_key} datasets have different number of images: "
                         f"{len(input_paths)}, {len(gt_paths)}.")
    input_names = {os.path.basename(p) for p in input_paths}
    paths = []
    for gt_path in sorted(gt_paths):
        basename, ext = os.path.splitext(os.path.basename(gt_path))
        input_name = f"{filename_tmpl.format(basename)}{ext}"
        if input_name not in input_names:
            raise ValueError(f"{input_name} is not in {input_key}_paths.")
        paths.append({f"{input_key}_path": os.path.join(input_folder, input_name),
                      f"{gt_key}_path": os.path.join(gt_folder, gt_path)})
    return paths


def paired_paths_from_meta_info_file(folders, keys, meta_info_file, filename_tmpl="{}"):
    """Pair from a meta-info text file of GT names."""
    input_folder, gt_folder = folders
    input_key, gt_key = keys
    with open(meta_info_file, "r") as fin:
        gt_names = [line.strip().split(" ")[0] for line in fin]
    paths = []
    for gt_name in gt_names:
        basename, ext = os.path.splitext(os.path.basename(gt_name))
        input_name = f"{filename_tmpl.format(basename)}{ext}"
        paths.append({f"{input_key}_path": os.path.join(input_folder, input_name),
                      f"{gt_key}_path": os.path.join(gt_folder, gt_name)})
    return paths


def paths_from_folder(folder):
    return [os.path.join(folder, p) for p in sorted(scandir(folder))]
