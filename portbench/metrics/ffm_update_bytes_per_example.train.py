"""The bytes of the ``[K, 128]`` f32 rows that the FFM scope hands the
sparse update (``ffm_update_bytes``, the loop's counter, from each
dispatch's shapes) per example of those steps (``ffm_update_examples``),
over the window's untraced passes: 1,024 B for two one-row slabs, 39,936 B
for 39 slabs of two rows."""


def read(ctx):
    c = ctx["counters"]
    if not c.get("ffm_update_examples") or "ffm_update_bytes" not in c:
        return None
    return c["ffm_update_bytes"] / c["ffm_update_examples"]
