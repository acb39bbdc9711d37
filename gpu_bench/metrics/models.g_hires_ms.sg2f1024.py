"""models.g_hires_ms.sg2f1024: the device extents of the generator's
``g.stage`` spans at 512x512 and 1024x1024 (each stage's convs and output
blocks), summed over the traced window, over its batches, in ms; nothing
where the program keeps no such span."""

from gpu_bench import spans

HIRES_PX = 512


def read(run):
    got = spans.load(run)
    if got is None:
        return None
    w, records = got
    ext = [w.extent(r) for r in records
           if r.name == "g.stage" and r.attrs.get("px", 0) >= HIRES_PX]
    ext = [e for e in ext if e]
    return sum(b - a for a, b in ext) / 1e3 / run["attempted"] if ext else None
