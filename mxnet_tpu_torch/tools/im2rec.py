"""im2rec: pack an image folder or ``.lst`` file into RecordIO.

ref: tools/im2rec.py — two modes::

    python -m mxnet_tpu_torch.tools.im2rec --list prefix image_root
    python -m mxnet_tpu_torch.tools.im2rec prefix image_root [--resize N]

The ``.lst`` format (tab-separated: index, label, relative path) is the
reference's, so existing lists work unchanged.  Packing writes
``prefix.rec`` + ``prefix.idx`` through ``mxnet_tpu_torch.recordio``
(the native core where it is built); ``io.ImageRecordIter`` reads them.
Host only: nothing here touches the card.
"""
from __future__ import annotations

import argparse
import os
import random
import sys

EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def make_list(prefix, root, recursive=True, train_ratio=1.0, shuffle=True):
    """Write ``prefix.lst`` (or ``prefix_train.lst`` + ``prefix_val.lst``
    for ``train_ratio < 1``): one label per subfolder, in sorted order;
    shuffled with seed 100."""
    paths = []
    classes = {}
    for dirpath, dirnames, filenames in sorted(os.walk(root)):
        dirnames.sort()
        for fn in sorted(filenames):
            if fn.lower().endswith(EXTS):
                rel = os.path.relpath(os.path.join(dirpath, fn), root)
                cls = os.path.dirname(rel) or "."
                label = classes.setdefault(cls, len(classes))
                paths.append((rel, label))
        if not recursive:
            break
    if shuffle:
        random.seed(100)
        random.shuffle(paths)
    n_train = int(len(paths) * train_ratio)
    splits = [("", paths)] if train_ratio >= 1.0 else \
        [("_train", paths[:n_train]), ("_val", paths[n_train:])]
    for suffix, items in splits:
        with open(f"{prefix}{suffix}.lst", "w") as f:
            for i, (rel, label) in enumerate(items):
                f.write(f"{i}\t{label}\t{rel}\n")
    print(f"wrote {len(paths)} entries over {len(classes)} classes")


def read_list(path):
    """``(index, label, relative path)`` of each line of a ``.lst``."""
    with open(path) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) >= 3:
                yield int(parts[0]), float(parts[1]), parts[-1]


def pack(prefix, root, resize=0, quality=95, color=1, raw=False):
    """Pack the images of ``prefix.lst`` (made first if missing) into
    ``prefix.rec`` + ``prefix.idx``: each resized so its short side is
    ``resize`` (0: as is), JPEG-encoded at ``quality``, or with ``raw``
    stored as unencoded uint8 pixels.  An image that fails to load is
    skipped with a message, as the reference does."""
    import numpy as np
    from PIL import Image

    from .. import recordio

    lst = prefix + ".lst"
    if not os.path.exists(lst):
        make_list(prefix, root)
    rec = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
    count = 0
    for idx, label, rel in read_list(lst):
        p = os.path.join(root, rel)
        try:
            img = Image.open(p)
            img = img.convert("RGB" if color else "L")
            if resize:
                scale = resize / min(img.size)
                img = img.resize((max(1, round(img.size[0] * scale)),
                                  max(1, round(img.size[1] * scale))))
            header = recordio.IRHeader(0, label, idx, 0)
            rec.write_idx(idx, recordio.pack_img(
                header, np.asarray(img), quality=quality,
                img_fmt=".raw" if raw else ".jpg"))
            count += 1
        except Exception as e:  # noqa: BLE001 — skip bad images like the ref
            print(f"skipping {p}: {e}", file=sys.stderr)
    rec.close()
    print(f"packed {count} images into {prefix}.rec")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("prefix")
    p.add_argument("root")
    p.add_argument("--list", action="store_true", help="generate .lst only")
    p.add_argument("--resize", type=int, default=0)
    p.add_argument("--quality", type=int, default=95)
    p.add_argument("--train-ratio", type=float, default=1.0)
    p.add_argument("--no-shuffle", action="store_true")
    p.add_argument("--gray", action="store_true")
    p.add_argument("--raw", action="store_true",
                   help="store pre-decoded uint8 pixels (pair with --resize)")
    a = p.parse_args(argv)
    if a.list:
        make_list(a.prefix, a.root, train_ratio=a.train_ratio,
                  shuffle=not a.no_shuffle)
    else:
        pack(a.prefix, a.root, resize=a.resize, quality=a.quality,
             color=0 if a.gray else 1, raw=a.raw)
    return 0


if __name__ == "__main__":
    sys.exit(main())
