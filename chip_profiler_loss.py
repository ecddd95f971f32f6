"""Where in a profiling session torch.profiler loses the device's kernel
records, and whether enclosing the session's work between runs of a pad
kernel absorbs the loss (chip_smoke.py's `device_profiler` does so).

Run on a machine with one NVIDIA GPU: `python3 chip_profiler_loss.py`.
A CUDA graph of 100 `neg`, 20000 `add` and 100 `abs` launches is replayed
3 times a session, in 10 sessions without pads and 10 with 256 `sqrt`
launches and a sync on each side (and 50 ms before the session ends);
then 8000 eager launches likewise. Each line gives the records missing of
each kind: a missing `neg` is lost at the session's head, a missing `abs`
at its tail.
"""
import time
import torch


def dev_events(prof):
    k = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events() if e.device_type == k]


def kind(name):
    for k in ("neg", "abs", "add", "mul", "sqrt"):
        if k in name.lower():
            return k
    return name[:60]


def window(fn, pad):
    torch.cuda.synchronize()
    y = torch.zeros(16, device="cuda")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        if pad:
            for _ in range(pad):
                y.sqrt_()
            torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        if pad:
            for _ in range(pad):
                y.sqrt_()
            torch.cuda.synchronize()
            time.sleep(0.05)
    ev = sorted(dev_events(prof), key=lambda e: e.time_range.start)
    cnt = {}
    for e in ev:
        k = kind(e.name)
        cnt[k] = cnt.get(k, 0) + 1
    seq = [kind(e.name) for e in ev]
    return cnt, seq


def body(x, n):
    for _ in range(100):
        x.neg_()
    for _ in range(n):
        x.add_(1.0)
    for _ in range(100):
        x.abs_()


def main():
    print(torch.__version__, torch.cuda.get_device_name(0), flush=True)
    x = torch.zeros(1024, device="cuda")
    n = 20000
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        body(x, n)
    torch.cuda.current_stream().wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        body(x, n)
    g.replay(); torch.cuda.synchronize()
    want = {"neg": 300, "add": 3 * n, "abs": 300}
    def three():
        for _ in range(3):
            g.replay()
    for t in range(10):
        for pad in (0, 256):
            cnt, seq = window(three, pad)
            miss = {k: want[k] - cnt.get(k, 0) for k in want}
            # where are the replay boundaries (first neg of each replay)?
            starts = [i for i, k in enumerate(seq) if k == "neg" and (i == 0 or seq[i - 1] != "neg")]
            print(f"graph t={t} pad={pad}: missing {miss}, sqrt {cnt.get('sqrt', 0)}/{2 * pad}, "
                  f"first kinds {seq[:3]} last {seq[-3:]}, replay starts {starts}", flush=True)
    for t in range(4):
        for pad in (0, 256):
            cnt, seq = window(lambda: body(x, 8000), pad)
            miss = {k: w - cnt.get(k, 0) for k, w in (("neg", 100), ("add", 8000), ("abs", 100))}
            print(f"eager t={t} pad={pad}: missing {miss}, sqrt {cnt.get('sqrt', 0)}/{2 * pad}, "
                  f"first {seq[:4]} last {seq[-4:]}", flush=True)


if __name__ == "__main__":
    main()
