"""File-type routing and small IO helpers.

The port's copy of ``utils/files.py`` in the JAX package (the reference's
``modules/utils/files.py``): mimetype-based image/video/camera routing and
pickle/json IO. ``read_pickle`` unpickles, which can run code: read only
files this program wrote.
"""
from __future__ import annotations

import glob
import json
import mimetypes
import os
import pickle
from collections import OrderedDict
from pathlib import Path
from typing import Any, Dict, Optional, Union


def get_file_type(file_src: Union[int, str]) -> Optional[str]:
    """'image' | 'video' | 'camera' | None based on extension / numeric id
    (``files.py:11-25``)."""
    if isinstance(file_src, int) or str(file_src).isnumeric():
        return "camera"
    mimetypes.init()
    mimestart = mimetypes.guess_type(str(file_src))[0]
    if mimestart is not None:
        kind = mimestart.split("/")[0]
        if kind in ("video", "image"):
            return kind
    return None


def read_pickle(path: str) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def write_pickle(path: str, obj: Any) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)


def read_json(path: str) -> dict:
    with Path(path).open("rt") as f:
        return json.load(f, object_hook=OrderedDict)


def write_json(content: Dict, path: str) -> None:
    with Path(path).open("wt") as f:
        json.dump(content, f, indent=4, sort_keys=False)


def gen_class2label_from_dir(data_dir: str, json_path: str) -> Dict[str, int]:
    """Alphabetical class -> label map of a one-level class tree (one
    directory a class under ``data_dir``), written to ``json_path`` and
    returned."""
    class_list = sorted(glob.glob(os.path.join(data_dir, "*")))
    class_list = [d for d in class_list if os.path.isdir(d)]
    mapping = {os.path.basename(d): i for i, d in enumerate(class_list)}
    write_json(mapping, json_path)
    return mapping


def fix_path_for_globbing(path: str) -> str:
    """A directory path ending in '/*', for class-tree globbing."""
    path = str(path)
    if path.endswith("/*"):
        return path
    return path.rstrip("/") + "/*"
