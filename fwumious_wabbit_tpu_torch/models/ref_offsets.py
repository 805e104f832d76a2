"""Reference tape-offset emulation for NN init seeding.

The reference seeds each neuron layer's Xoshiro256++ from its tape offsets:
``seed = input_offset * output_offset + num_inputs + weights_len``
(reference: src/block_neural.rs:384-388). Those offsets come from the
block-graph finalize pass (reference: src/graph.rs:250-285): blocks are
walked in creation order; each block's input edges claim tape space for
their source outputs sequentially, EXCEPT zero-copy aliases — a Join
source, or a Copy source's slot 0 consumed by a non-Join — which reuse the
source's own input offset.

The port has no tape (PyTorch owns the buffers), so this module
re-derives the offsets the reference WOULD assign for the canonical
model graphs built by regressor.rs:183-320 (LR ⊕ triangle(FFM) → topology
one/two/four/five → layers with optional layernorm/relu → join → final
1-neuron readout). That makes NN weight init bit-compatible with the
reference for every supported topology — the last piece of ``--fwt_exact``
init parity (LR is zero-init; FFM uses merand48, ops/init.py).

The port's own copy of fwumious_wabbit_tpu/models/ref_offsets.py (numpy only),
held to the original by tests/test_torch_nn_init.py.
"""

from __future__ import annotations


def _walk(blocks):
    """The finalize offset assignment (reference: src/graph.rs:250-285)."""
    offset = 0
    for b in blocks:
        for slot_i, (src, so) in enumerate(b["inputs"]):
            sb = blocks[src]
            stype = sb["type"]
            if stype == "join" or (
                stype == "copy" and so == 0 and b["type"] != "join"
            ):
                fake = sb["input_offsets"][0]
                sb["output_offsets"][so] = fake
                b["input_offsets"][slot_i] = fake
            else:  # regular source, copy slot ≥ 1, or copy slot 0 → join
                sb["output_offsets"][so] = offset
                b["input_offsets"][slot_i] = offset
                offset += sb["out_sizes"][so]
    return offset


def reference_nn_offsets(num_combos: int, num_fields: int, topology: str,
                         layer_widths: list) -> list:
    """Per neuron layer: ``(input_offset, output_offset, num_inputs,
    num_neurons)`` exactly as the reference graph assigns them; the final
    1-neuron readout layer is last.

    ``num_combos`` includes the constant feature; ``num_fields`` 0 = no FFM
    block; ``layer_widths`` covers hidden layers in order, each entry
    ``(width, layernorm, activation)`` with layernorm in
    {'none','before','after'} and activation in {'none','relu'}.
    """
    blocks: list = []

    def add(btype, inputs, out_sizes):
        blocks.append({
            "type": btype,
            "inputs": list(inputs),
            "out_sizes": list(out_sizes),
            "input_offsets": [None] * len(inputs),
            "output_offsets": [None] * len(out_sizes),
        })
        return len(blocks) - 1

    C = num_combos
    lr = add("regular", [], [C])
    out = (lr, 0)
    D = C
    if num_fields > 0:
        F = num_fields
        T = F * (F + 1) // 2  # triangle keeps the lower half incl. diagonal
        ffm = add("regular", [], [F * F])
        tri = add("regular", [(ffm, 0)], [T])
        j = add("join", [out, (tri, 0)], [C + T])
        out = (j, 0)
        D = C + T

    join_side = None
    if topology in ("one", "four", "five"):
        cp = add("copy", [out], [D, D])
        out = (cp, 0)
        join_side = (cp, 1)
        if topology == "four":
            nb = add("regular", [out], [D])  # BlockNormalize
            out = (nb, 0)
        elif topology == "five":
            sb = add("regular", [out], [D])  # BlockStopBackward
            out = (sb, 0)
    elif topology != "two":
        raise ValueError(f'unknown nn topology: "{topology}"')

    nn_blocks = []
    d = D
    for width, layernorm, activation in layer_widths:
        nl = add("regular", [out], [width])
        nn_blocks.append((nl, d, width))
        out = (nl, 0)
        d = width
        if layernorm == "before":
            out = (add("regular", [out], [width]), 0)
        if activation == "relu":
            out = (add("regular", [out], [width]), 0)
        if layernorm == "after":
            out = (add("regular", [out], [width]), 0)

    if join_side is not None:
        j2 = add("join", [out, join_side], [d + D])
        out = (j2, 0)
        d = d + D
    fin = add("regular", [out], [1])
    nn_blocks.append((fin, d, 1))
    # the sigmoid loss block consumes the final output (assigning its
    # offset); its own output is sunk after — neither affects NN offsets
    add("regular", [(fin, 0)], [1])

    _walk(blocks)

    result = []
    for idx, num_inputs, width in nn_blocks:
        b = blocks[idx]
        result.append((b["input_offsets"][0], b["output_offsets"][0],
                       num_inputs, width))
    return result


def layer_seed(input_offset: int, output_offset: int, num_inputs: int,
               num_neurons: int) -> int:
    """reference: src/block_neural.rs:384-388 — weights_len is
    num_inputs·num_neurons + num_neurons (biases)."""
    weights_len = num_inputs * num_neurons + num_neurons
    return (input_offset * output_offset + num_inputs + weights_len) & (
        (1 << 64) - 1
    )
