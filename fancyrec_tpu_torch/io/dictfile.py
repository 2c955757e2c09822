"""Python-literal dict files (video2frames.txt, img_info.txt, video_info.txt).

The reference reads these with eval() (util/util.py:75-88); we parse with
ast.literal_eval -- same grammar for the data actually written (str() of a
dict of str/int/list), without executing arbitrary code.
"""

from __future__ import annotations

import ast
from typing import Any, Dict


def read_dict(filepath: str) -> Dict[Any, Any]:
    with open(filepath, "r") as f:
        return ast.literal_eval(f.read())


def write_dict(filepath: str, dict_data: Dict[Any, Any]) -> None:
    with open(filepath, "w") as f:
        f.write(str(dict_data))


def get_visual_id(cap_id: str) -> str:
    """caption id -> visual id: 'video12#enc#0' -> 'video12' (ref util/util.py:92-96)."""
    vid_id = cap_id.split("#")[0]
    if vid_id.endswith(".jpg") or vid_id.endswith(".mp4"):
        vid_id = vid_id[:-4]
    return vid_id
