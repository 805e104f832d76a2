"""Command line — same flag vocabulary as the reference
(reference: src/cmdline.rs:9-322), plus TPU-specific extensions under the
``fwt: TPU execution`` group (batch size, mesh shape, device selection).

The port's own copy of fwumious_wabbit_tpu/config/cmdline.py, the same in
behaviour; it imports nothing of that package.
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fwt",
        description="fwumious_wabbit_tpu: TPU-native online CTR engine "
        "(LR + field-aware factorization machines + dense towers)",
    )
    # -- input / output ----------------------------------------------------
    p.add_argument("--data", "-d", help="File with input examples (also .gz/.zst)")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("-p", "--predictions", dest="predictions", help="Output predictions file")
    p.add_argument(
        "-c", "--cache", action="store_true", help="Use an input cache file (.fwcache)"
    )
    p.add_argument("--save_resume", action="store_true",
                   help="Required with --final_regressor; keeps optimizer state in the model")
    p.add_argument("--build_cache_without_training", action="store_true")
    p.add_argument("-f", "--final_regressor", help="Save final model to this file")
    p.add_argument("-i", "--initial_regressor", help="Load initial model from this file")
    p.add_argument("-t", "--testonly", action="store_true", help="Ignore label, only predict")
    p.add_argument("--predictions_stdout", action="store_true")
    p.add_argument("--predictions_after", type=int, default=None,
                   help="Start writing predictions after this many examples")
    p.add_argument("--holdout_after", type=int, default=None,
                   help="Stop learning after this many examples (holdout evaluation)")
    p.add_argument("--prediction_model_delay", type=int, default=None,
                   help="Evaluate examples with a model this many examples old")

    # -- features ------------------------------------------------------------
    p.add_argument("--keep", action="append", metavar="NS")
    p.add_argument("--interactions", action="append", metavar="NSNS")
    p.add_argument("--linear", action="append", metavar="verbose,names[:weight]")
    p.add_argument("--transform", action="append", metavar="out=Func(ns)(args)")
    p.add_argument("--noconstant", action="store_true")
    p.add_argument("-b", "--bit_precision", type=int, default=None)
    p.add_argument("--hash", default=None, help="Only --hash all is supported")

    # -- learning ------------------------------------------------------------
    p.add_argument("-l", "--learning_rate", type=float, default=None)
    p.add_argument("--minimum_learning_rate", type=float, default=None)
    p.add_argument("--power_t", type=float, default=None)
    p.add_argument("--init_acc_gradient", type=float, default=None)
    p.add_argument("--l2", type=float, default=None)
    p.add_argument("--sgd", action="store_true")
    p.add_argument("--adaptive", action="store_true")
    p.add_argument("--link", default=None)
    p.add_argument("--loss_function", default=None)
    p.add_argument("--vwcompat", action="store_true")

    # -- FFM -----------------------------------------------------------------
    p.add_argument("--ffm_k", type=int, default=None)
    p.add_argument("--ffm_field", action="append", metavar="NS...")
    p.add_argument("--ffm_field_verbose", action="append")
    p.add_argument("--ffm_bit_precision", type=int, default=None)
    p.add_argument("--ffm_learning_rate", type=float, default=None)
    p.add_argument("--ffm_power_t", type=float, default=None)
    p.add_argument("--ffm_init_acc_gradient", type=float, default=None)
    p.add_argument("--ffm_k_threshold", type=float, default=None)
    p.add_argument("--ffm_init_center", type=float, default=None)
    p.add_argument("--ffm_init_width", type=float, default=None)
    p.add_argument("--ffm_init_zero_band", type=float, default=None)
    p.add_argument("--ffm_initialization_type", default=None)

    # -- NN tower --------------------------------------------------------------
    p.add_argument("--nn_layers", type=int, default=None)
    p.add_argument("--nn", action="append", metavar="layer:param:value")
    p.add_argument("--nn_topology", default=None, choices=["one", "two", "four", "five"])
    p.add_argument("--nn_learning_rate", type=float, default=None)
    p.add_argument("--nn_power_t", type=float, default=None)
    p.add_argument("--nn_init_acc_gradient", type=float, default=None)

    # -- serving / ops -----------------------------------------------------------
    p.add_argument("--daemon", action="store_true")
    p.add_argument("--port", type=int, default=26542)
    p.add_argument("--num_children", type=int, default=10)
    p.add_argument("--foreground", action="store_true")
    p.add_argument("--convert_inference_regressor", help="Output path for inference model")
    p.add_argument("--weight_quantization", action="store_true")

    # -- hogwild flags accepted for CLI compatibility; on TPU these select the
    #    synchronous large-batch data-parallel path (see parallel/) -----------
    p.add_argument("--hogwild_training", action="store_true")
    p.add_argument("--hogwild_threads", type=int, default=None)

    # -- TPU execution extensions (not in the reference) ----------------------
    g = p.add_argument_group("fwt: TPU execution")
    g.add_argument("--fwt_batch_size", type=int, default=1024,
                   help="Device batch size for the synchronous training step")
    g.add_argument("--fwt_platform", default=None,
                   help="Force a JAX platform (cpu/tpu); default: auto")
    g.add_argument("--fwt_pack_cache", choices=["auto", "on", "off"],
                   default="auto",
                   help="Cache the packed superbatch stream "
                        "(<input>.fwpack) and replay it on re-runs over "
                        "the same input+config: multipass/epoch re-reads "
                        "skip parse/translate/fill/counts/pack entirely. "
                        "auto = engage when -c is given (like the record "
                        "cache); on = always; off = never")
    g.add_argument("--fwt_compile_cache", default=None, metavar="DIR",
                   help="Persistent XLA compilation cache directory "
                        "(skips recompiles across processes; also pins "
                        "one compiled program where the compiler is "
                        "run-to-run nondeterministic). Default: "
                        "~/.cache/fwt_xla on non-CPU platforms; 'off' "
                        "disables")
    g.add_argument("--fwt_data_axis", type=int, default=None,
                   help="Number of devices on the data-parallel mesh axis")
    g.add_argument("--fwt_table_axis", type=int, default=1,
                   help="Number of devices on the table (row-shard) mesh axis")
    g.add_argument("--fwt_exchange", choices=["auto", "psum", "a2a"],
                   default="auto",
                   help="Sharded-table exchange: 'a2a' = all-to-all id "
                        "exchange (per-shard comms shrink with the table "
                        "axis; default when --fwt_table_axis > 1), 'psum' = "
                        "masked-gather reduction (simple, small meshes)")
    g.add_argument("--fwt_a2a_capacity", type=float, default=2.0,
                   help="Slack factor for per-destination all-to-all send "
                        "capacity (slots = slack*K/n_table)")
    g.add_argument("--fwt_hosts", type=int, default=None,
                   help="Number of host processes in a multi-host run "
                        "(jax.distributed); run one process per host")
    g.add_argument("--fwt_host_id", type=int, default=None,
                   help="This process's index in a --fwt_hosts run")
    g.add_argument("--fwt_coordinator", default=None, metavar="HOST:PORT",
                   help="Coordinator address for a --fwt_hosts run "
                        "(host 0's address)")
    g.add_argument("--fwt_batch_mean", choices=["off", "on", "auto"],
                   default="auto",
                   help="Cap each weight's effective per-batch multiplicity "
                        "at --fwt_batch_cap (hot weights' summed gradients "
                        "are scaled to that many online updates' worth; "
                        "cold weights unchanged). 'auto' = only AdaGrad "
                        "scopes with power_t 0, whose constant rate makes "
                        "the summed form diverge at large batch. Identical "
                        "at batch size 1 in every mode")
    g.add_argument("--fwt_pallas_update", choices=["off", "on", "auto"],
                   default="auto",
                   help="Route sparse AdaGrad updates through the Pallas "
                        "table-sweep kernel (1.4-11x the XLA scatter for "
                        "tables >= 2^26 on v5e); 'auto' applies its measured "
                        "size/density rule")
    g.add_argument("--fwt_batch_cap", type=float, default=8.0,
                   help="Multiplicity cap for --fwt_batch_mean (1.0 = pure "
                        "per-weight mean)")
    g.add_argument("--fwt_exact", action="store_true",
                   help="Batch size 1, f32, no fusion: bit-faithful online mode")
    g.add_argument("--fwt_no_native", action="store_true",
                   help="Disable the C++ ingest engine (use the Python pipeline)")
    g.add_argument("--fwt_serve_engine", choices=["auto", "native", "device"],
                   default="auto",
                   help="Daemon prediction engine: embedded C++ (microsecond "
                        "latency) or the jitted device step")
    g.add_argument("--fwt_profile", default=None, metavar="DIR",
                   help="Write a jax.profiler trace of the run to DIR "
                        "(view with TensorBoard / xprof)")
    g.add_argument("--fwt_superbatch", type=int, default=0, metavar="K",
                   help="Pack K consecutive train batches into one "
                        "host→device transfer + one scanned dispatch "
                        "(amortizes per-RPC link latency; trajectory "
                        "identical to K separate steps). 0 = auto "
                        "(8 on the native single-device path), 1 = off")
    g.add_argument("--fwt_bitpack", choices=["auto", "on", "off"],
                   default="auto",
                   help="Bit-pack the lr id column of the packed transfer "
                        "to its actual width (hash bits + packed combo "
                        "bits; 27 vs 32 on the b=25 benchmark schema — "
                        "~16%% of the dominant uplink column on a "
                        "bandwidth-bound link). Undone device-side with "
                        "static shifts fused into the step; trajectory "
                        "identical. auto = on")
    g.add_argument("--fwt_vocab", choices=["auto", "on", "off"],
                   default="auto",
                   help="Dictionary-encode the packed transfer's lr id "
                        "columns: each fixed-width column ships "
                        "ceil(log2(vocabulary))-bit dictionary indices "
                        "and the device resolves them against a resident "
                        "vocabulary snapshot (shipped only when it grows; "
                        "high-cardinality columns such as interaction "
                        "combos degrade to direct ids automatically). "
                        "45 → ~25 B/example on the b=25 benchmark schema; "
                        "trajectory identical. auto = on")
    g.add_argument("--fwt_fetch_stack", type=int, default=0, metavar="M",
                   help="Write each packed step's predictions into a "
                        "device-resident [M, K, B] ring inside the step "
                        "program and fetch the ring once per M "
                        "superbatches — M× fewer device→host fetch RPCs "
                        "with zero extra dispatches. Pure transfer "
                        "plumbing — written predictions are identical. "
                        "0 = auto (default): per-step async fetches until "
                        "a fetch measures slow (FWT_RING_AUTO_MS, default "
                        "250 ms — the degraded-link signature), then the "
                        "ring engages at M=4. 1 = never")
    return p


def parse(argv=None) -> argparse.Namespace:
    return build_parser().parse_args(argv)
