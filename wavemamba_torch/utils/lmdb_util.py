"""Making LMDB datasets (`basicsr/utils/lmdb_util.py:9-196`,
`create_lmdb.py`). The counterpart of `wavemamba_tpu/utils/lmdb_util.py`.
Requires the optional `lmdb` package (a C library) — gated with a clear
error when absent — and OpenCV to re-encode the images."""

from __future__ import annotations

import hashlib
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from wavemamba_torch.utils.misc import scandir


def _require_lmdb():
    try:
        import lmdb  # noqa: F401

        return lmdb
    except ImportError as e:
        raise ImportError(
            "LMDB support needs the 'lmdb' package, which is not installed; "
            "use the disk backend instead."
        ) from e


def make_lmdb_from_imgs(data_path, lmdb_path, img_path_list=None, keys=None,
                        batch=5000, compress_level=1, map_size=None, n_thread=8):
    """Build an .lmdb folder (data.mdb + meta_info.txt) from images.

    meta_info lines: `<key>.png (h, w, c) <compress_level>` — the format
    `paired_paths_from_lmdb` and the LMDB file client consume.
    """
    lmdb = _require_lmdb()
    if not lmdb_path.endswith(".lmdb"):
        raise ValueError("lmdb_path must end with '.lmdb'.")
    if os.path.exists(lmdb_path):
        raise FileExistsError(f"Folder {lmdb_path} already exists.")
    if img_path_list is None:
        img_path_list = sorted(scandir(data_path, suffix=(".png", ".jpg")))
    if keys is None:
        keys = [os.path.splitext(p)[0] for p in img_path_list]

    import cv2

    def read_img(path):
        with open(os.path.join(data_path, path), "rb") as f:
            buf = f.read()
        img = cv2.imdecode(np.frombuffer(buf, dtype=np.uint8),
                           cv2.IMREAD_UNCHANGED)
        _, enc = cv2.imencode(".png", img,
                              [cv2.IMWRITE_PNG_COMPRESSION, compress_level])
        if img.ndim == 2:
            h, w = img.shape
            c = 1
        else:
            h, w, c = img.shape
        return enc.tobytes(), (h, w, c)

    with ThreadPoolExecutor(n_thread) as pool:
        encoded = list(pool.map(read_img, img_path_list))

    if map_size is None:
        map_size = sum(len(e[0]) for e in encoded) * 2 + (1 << 26)
    env = lmdb.open(lmdb_path, map_size=map_size)
    txn = env.begin(write=True)
    meta_lines = []
    for i, (key, (data, (h, w, c))) in enumerate(zip(keys, encoded)):
        txn.put(key.encode("ascii"), data)
        meta_lines.append(f"{key}.png ({h},{w},{c}) {compress_level}\n")
        if (i + 1) % batch == 0:
            txn.commit()
            txn = env.begin(write=True)
    txn.commit()
    env.close()
    with open(os.path.join(lmdb_path, "meta_info.txt"), "w") as f:
        f.writelines(meta_lines)


def file_md5(path, chunk=1 << 20):
    md5 = hashlib.md5()
    with open(path, "rb") as f:
        while True:
            data = f.read(chunk)
            if not data:
                break
            md5.update(data)
    return md5.hexdigest()
