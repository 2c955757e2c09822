"""video2frames.txt writer (reference preprocess/get_frameInfo.py:22-60).

Groups BigFile frame ids 'video{id}_{frameno}_cls{brand}' per video, sorts
by frame number, writes the python-literal dict file next to the features.
"""

from __future__ import annotations

import os
from typing import Dict, List

from fancyrec_tpu_torch.io.bigfile import ImageBigFile
from fancyrec_tpu_torch.io.dictfile import write_dict


def get_frame_info(feature_dir: str, overwrite: int = 0) -> Dict[str, List[str]]:
    target = os.path.join(feature_dir, "video2frames.txt")
    if os.path.exists(target) and not overwrite:
        print("%s exists. skip" % target)
        return {}
    feat = ImageBigFile(feature_dir)
    video2frame_no: Dict[str, List[int]] = {}
    video2cls: Dict[str, str] = {}
    for frame_id in feat.names:
        video_id, fm_no, video_cls = frame_id.strip().split("_")
        video2frame_no.setdefault(video_id, []).append(int(fm_no))
        video2cls.setdefault(video_id, video_cls)
    video2frames = {
        vid: ["%s_%d_%s" % (vid, no, video2cls[vid]) for no in sorted(nos)]
        for vid, nos in video2frame_no.items()
    }
    write_dict(target, video2frames)
    return video2frames


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--feature_dir", required=True)
    p.add_argument("--overwrite", type=int, default=0)
    a = p.parse_args(argv)
    get_frame_info(a.feature_dir, a.overwrite)


if __name__ == "__main__":
    main()
