"""A few compute threads for the benchmark's CPU tests, the tiny sizes
they run the cells at (the benchmark itself runs only the files' own
sizes, on a card), and the benchmark's spec with the serving cell."""
import pytest
import torch

from h100_bench import spec as spec_mod

torch.set_num_threads(2)

TINY = {"cfg": {"generator": {"n_channels": 8, "latent_dim": 8,
                              "sentence_dim": 16, "affine_hidden": 16,
                              "image_size": 32},
                "text_encoder": {"vocab_size": 60, "embed_dim": 12,
                                 "hidden_dim": 16},
                "train": {"batch_size": 4}},
        "mix": {"images": 16, "width": [40, 60], "height": [32, 60],
                "decode_threads": 2, "rate_per_s": 20.0, "batch_size": 4,
                "concurrency": 8, "prompt_pool_per_s": 3000}}


@pytest.fixture
def tiny():
    return TINY


# The HTTP serving cell: its driver, mixes, readers and limits are kept,
# though BENCHMARK.json holds no serving cell (its numbers swing with the
# host's load beyond any bound); the tests hold them as they would run.
SERVE = "cub256-fp32-serve"
SERVE_CELL = {"name": SERVE, "config": "dfgan-cub256-fp32",
              "traffic": "prompts-closed-c48", "chips": 1,
              "why": "HTTP /generate, a closed loop of 48 in flight"}
SERVE_E2E = {"name": "serve_img_per_s", "unit": "img/s", "better": "higher",
             "bound": 0.25, "source": "host_clock", "workloads": [SERVE]}
SERVE_PER_LAYER = [  # (name, unit, better, source, layer)
    ("batch_fill.serve", "%", "higher", "program_counter", "batching"),
    ("handler_ms.serve", "ms", "lower", "program_span", "HTTP"),
    ("idle_pct.serve", "%", "lower", "device_trace", "device"),
    ("p50_ms.serve", "ms", "lower", "host_clock", "HTTP"),
    ("p95_ms.serve", "ms", "lower", "host_clock", "HTTP")]


@pytest.fixture
def bench():
    """`BENCHMARK.json`'s spec with the serving cell and its metrics
    added."""
    s = spec_mod.Spec()
    if SERVE not in s.cell_names():
        m = s.manifest
        m["workloads"].append(SERVE_CELL)
        m["end_to_end"].insert(-1, SERVE_E2E)
        m["per_layer"] += [
            {"name": n, "unit": u, "better": b, "source": src, "layer": lay,
             "moves": SERVE_E2E["name"], "workloads": [SERVE]}
            for n, u, b, src, lay in SERVE_PER_LAYER]
    return s
