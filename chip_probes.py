#!/usr/bin/env python3
"""Two measurements behind `chip_smoke.py`'s rank worlds, on one NVIDIA GPU.

    python3 chip_probes.py imports    # a rank process's start-up, by part
    python3 chip_probes.py maxpool    # 11c's update on the 204-post tree

imports: the seconds of a bare Python start, `import torch`, torch with a
CUDA context, the imports of `chip_smoke._RANK_MAIN` (the rank header),
and the header with a CUDA context and one kernel library loaded, before
and after the kernel is built: what every rank process of a world pays
before its own work.

maxpool: one update (`chip_smoke.run_jobs` "step" jobs, every dropout off)
on phase 10's 204-post tree in one process and at --mesh_shape 2,2 (twice),
2,1 and 1,2, each held against the one-process update with
`chip_smoke.update_diff`; for each microbatch, the rows and channels of the
text conv bank's window-3 max-pool whose position (argmax) moves against
the one-process run, with the two largest values of the one-process run
there; and the channels of that branch's weight grad that differ by more
than 1e-5 of the tensor's largest grad.

Exits non-zero without a CUDA device.
"""

import json
import os
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# recorded in every rank: for the first 8 training calls of the text conv
# bank (BERT's hidden width), the window-3 branch's two largest values and
# their positions
_HOOK = r'''
from fancyrec_tpu_torch.models import layers as _L
_fwd = _L.ConvBank.forward
_rec = {}
def _hook(self, x, batch_len):
    if x.shape[-1] == 768 and torch.is_grad_enabled() and len(_rec) < 8:
        with torch.no_grad():
            xt, t = x.transpose(1, 2), x.shape[1]
            y = torch.relu(self._conv(self.conv_w3, xt))
            pos = torch.arange(t + 2, device=x.device)
            valid = (pos < batch_len + 2)[None, None, :]
            y = torch.where(valid, y, torch.full_like(
                y, torch.finfo(y.dtype).min))
            top = torch.topk(y, 2, dim=2)
            _rec[len(_rec)] = (top.values.cpu(), top.indices.cpu())
        torch.save(_rec, "%s.conv.%d.pt" % (job["out"], collectives.rank()))
    return _fwd(self, x, batch_len)
_L.ConvBank.forward = _hook
'''


def probe_imports():
    import chip_smoke as cs
    from fancyrec_tpu_torch.ops import _build

    env = dict(os.environ, PYTHONPATH=HERE)
    header = cs._RANK_MAIN.split("job = {}")[0].replace(
        "here, jobs = sys.argv[1], json.loads(sys.argv[2])",
        "here = %r" % HERE)
    cases = [
        ("python alone", "pass"),
        ("import torch", "import torch"),
        ("torch and a CUDA context",
         "import torch; torch.zeros(1, device='cuda')"),
        ("the rank header", header),
        ("the rank header, a CUDA context and gru_scan's library",
         header + "\ntorch.zeros(1, device='cuda')\n"
         "from fancyrec_tpu_torch.ops import _build\n"
         "_build.load('gru_scan')\n")]
    for built in (False, True):
        if built:
            _build.build(["gru_scan"])
        for label, code in cases[3 if built else 0:]:
            t0 = time.time()
            out = subprocess.run([sys.executable, "-c", code], env=env,
                                 cwd=HERE, capture_output=True, text=True)
            if out.returncode:
                cs.fail("%s exited %d:\n%s" % (label, out.returncode,
                                               out.stderr[-3000:]))
            cs.log("%s%s: %.2f s" % (label, " (kernel built)" if built
                                     else "", time.time() - t0))


def probe_maxpool():
    import torch
    import chip_smoke as cs
    from fancyrec_tpu_torch.ops import _build
    from fancyrec_tpu_torch.utils.fixture import make_fixture

    cs._RANK_MAIN = cs._RANK_MAIN.replace(
        "for n_job, (mode, out, argv) in enumerate(jobs):",
        _HOOK + "for n_job, (mode, out, argv) in enumerate(jobs):", 1)
    _build.build(["gru_scan", "aspect_dropout", "cosine_scores"])
    work = os.path.join(HERE, "build", "chip_probes")
    shutil.rmtree(work, ignore_errors=True)
    root = os.path.join(work, "small")
    try:
        make_fixture(root, brand_num=cs.N_BRANDS,
                     videos_per_brand=cs.SMALL_VIDEOS_PER_BRAND,
                     imgs_per_brand=cs.SMALL_IMGS_PER_BRAND,
                     feat_dim=cs.D_IN, frames_per_video=cs.FRAMES,
                     seed=cs.SEED)
        flags = ["--device", "cuda", "--dropout", "0", "--bert_dropout", "0"]
        runs = {}
        for name, ranks, shape in (("one", 0, ""), ("w22", 4, "2,2"),
                                   ("w22b", 4, "2,2"), ("w21", 2, "2,1"),
                                   ("w12", 2, "1,2")):
            argv = cs.instance_args(root, name, 1) + flags
            if shape:
                argv += ["--mesh_shape", shape]
            runs[name] = cs.run_ranks("step", os.path.join(root, name), argv,
                                      ranks)
        first = {n: torch.load(os.path.join(root, n + ".first.pt"))
                 for n in runs}
        conv = "text_encoding.convs.conv_w3.weight"
        for name in ("w22", "w22b", "w21", "w12"):
            text, ok = cs.update_diff(first["one"], first[name],
                                      runs["one"][0]["loss"],
                                      runs[name][0]["loss"])
            g1, g2 = first["one"]["grads"][conv], first[name]["grads"][conv]
            per = (g1 - g2).abs().amax(dim=(1, 2)) / g1.abs().max()
            cs.log("%s vs one process: %s (%s); %s channels differing by "
                   "more than 1e-5 of its largest grad: %s"
                   % (name, text, "within" if ok else "OUTSIDE", conv,
                      torch.nonzero(per > 1e-5).flatten().tolist()))
        same = all(torch.equal(t, first["w22b"]["grads"][k])
                   for k, t in first["w22"]["grads"].items())
        cs.log("two (2, 2) runs: grads %s" % ("bit-equal" if same
                                               else "DIFFER"))
        one = torch.load(os.path.join(root, "one.conv.0.pt"))
        for name, ranks in (("w22", (0, 2)), ("w21", (0, 1)), ("w12", (0,))):
            parts = [torch.load(os.path.join(root, "%s.conv.%d.pt"
                                             % (name, r))) for r in ranks]
            for m in sorted(one):
                v1, i1 = one[m]
                v2 = torch.cat([p[m][0] for p in parts])
                i2 = torch.cat([p[m][1] for p in parts])
                moved = (i1[..., 0] != i2[..., 0]) & (v1[..., 0] > 0)
                cases = [(r, c, v1[r, c, 0].item(), v1[r, c, 1].item(),
                          v2[r, c, 0].item())
                         for r, c in torch.nonzero(moved).tolist()]
                if cases:
                    cs.log("%s, microbatch %d: the max-pool position moves at "
                           "(row, channel, one process's largest and second "
                           "values, this run's largest) %s"
                           % (name, m, json.dumps(cases)))
            cs.log("%s: %d microbatches compared" % (name, len(one)))
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main():
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: these probes need a card")
    cs.log(cs.smi_name_power())
    what = sys.argv[1:] or ["imports", "maxpool"]
    for name in what:
        {"imports": probe_imports, "maxpool": probe_maxpool}[name]()


if __name__ == "__main__":
    main()
