"""The port's CUDA kernels on the card (skipped on hosts without one).

Run on a machine with an NVIDIA card and ``nvcc``:

    python -m pytest tests/test_torch_cuda.py

Each kernel must equal its plain PyTorch version exactly, and short
Kademlia runs must be leaf-identical between ``inbox_impl="scatter"`` and
``"pallas"`` on the card, for the dense tick and for the sparse tick
under lifetime churn; Chord + KBRTest, and Kademlia + DHT and Chord +
DHT, EpiChord and the router-topology underlay, and a campaign of four
rows, on the card must equal the CPU's torch ops on both ticks, and so
must the service loop resumed from its checkpoint; ``inject_ext_batch`` into a card pool must equal the same
into a host pool.  ``chip_smoke.py`` makes the same checks at the paths'
full shapes.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


def test_kernels_equal_plain_versions(card):
    """Every case 50 times back to back: both inbox entries on the
    random, R-overflow and hold-mask pools and the edge cases (one
    destination, equal times, n = 1, n at a scan tile +-1); alloc_dest on
    random draws and at tile sizes, no free slot, all free, crossings
    inside a tile and on its edge, 0.1% wanted; compact_indices on random
    masks, none and all set, set counts of cap - 1, cap and cap + 1, a
    mask viewed at a 1-byte offset, m = 0 and 1 and m at a tile +-1 under
    a cap above m; inbox_gather at W in {1, 2, 4, 31, 32, 33}, all
    entries empty and all full."""
    import chip_smoke
    worst, cases = chip_smoke.check_inbox(512, card)
    assert worst == 0 and cases == 7
    worst, cases = chip_smoke.check_inbox_edges(512, card)
    assert worst == 0 and cases == 7
    worst, cases = chip_smoke.check_alloc(512, card)
    assert worst == 0 and cases > 20
    worst, cases = chip_smoke.check_alloc_edges(card)
    assert worst == 0 and cases == 12
    worst, cases = chip_smoke.check_compact(4096, 512, card)
    assert worst == 0 and cases == 21
    worst, cases = chip_smoke.check_gather(card)
    assert worst == 0 and cases == 8


def test_scatter_and_kernel_ticks_identical(card):
    import chip_smoke
    from oversim_tpu_torch import kernels
    kernels.reset_launches()
    out = chip_smoke.phase_identity(card, 256, ticks=40)
    assert out["leaves"] > 100 and out["alive"] > 0
    assert min(kernels.LAUNCHES[k] for k in chip_smoke.DENSE_KERNELS) > 0
    assert np.isfinite(out["seconds"])


def test_sparse_tick_on_card_matches_cpu(card):
    import chip_smoke
    from oversim_tpu_torch import kernels
    kernels.reset_launches()
    out = chip_smoke.phase_sparse_reference(card, ticks=64)
    assert out["leaves"] > 100 and out["dest_unavailable_lost"] > 0
    assert min(kernels.LAUNCHES[k] for k in chip_smoke.SPARSE_KERNELS) > 0


def test_chord_on_card_matches_cpu(card):
    """Chord + KBRTest at N=16 on the kernels against the CPU's torch ops
    (float leaves within 1e-12 relative), and Chord's sparse tick under lifetime
    churn likewise, each launching its path's kernels."""
    import chip_smoke
    from oversim_tpu_torch import kernels
    kernels.reset_launches()
    out = chip_smoke.phase_chord_reference(card)
    assert out["leaves"] > 100 and out["kbr_delivered"] > 0
    assert min(kernels.LAUNCHES[k] for k in chip_smoke.DENSE_KERNELS) > 0
    out, launches = chip_smoke.phase_chord_sparse_reference(card)
    assert out["leaves"] > 100 and min(launches.values()) > 0


def test_dht_on_card_matches_cpu(card):
    """Kademlia + DHT and Chord + DHT at 16 slots on the kernels against
    the CPU's torch ops, every DHT hook acting, and Kademlia + DHT on
    the sparse tick likewise, each launching its path's kernels."""
    import chip_smoke
    out = chip_smoke.phase_dht_reference(card)
    assert out["kad"]["leaves"] > 100 and out["chord"]["leaves"] > 100
    assert out["chord"]["hooks"]["update_urgent"] > 0
    assert min(out["launches"].values()) > 0
    out, launches = chip_smoke.phase_dht_sparse_reference(card)
    assert out["leaves"] > 100 and min(launches.values()) > 0


def test_campaign_on_card_matches_cpu(card):
    """A campaign of four rows over a window and interval grid, with
    telemetry, on the kernels against the CPU's torch ops, through
    ``run_until_device``; a sparse-tick campaign likewise.  Every row
    stays on the card."""
    import chip_smoke
    from oversim_tpu_torch import kernels, tree
    kernels.reset_launches()
    out, launches = chip_smoke.phase_campaign_reference(card, ticks=32,
                                                        until_s=5.0)
    assert out["leaves"] > 100 and out["leaves_until"] == out["leaves"]
    assert min(launches.values()) > 0
    assert min(kernels.LAUNCHES[k] for k in chip_smoke.DENSE_KERNELS) > 0
    camp = chip_smoke.tiny_campaign(card, "pallas")
    rows = camp.run_chunk(camp.init(), 4)
    assert all(leaf.is_cuda for row in rows
               for _, leaf in tree.leaves_with_path(row))


def test_service_plane_on_card(card):
    """The service loop's checkpoint and resume on the card against the
    CPU (``service_reference``), and ``inject_ext_batch`` into a card pool
    (``alloc_dest`` at the inject call site) equal to the same frames
    into a host pool (its plain version)."""
    import dataclasses
    import chip_smoke
    from oversim_tpu_torch import interop, kernels
    from oversim_tpu_torch.engine import pool as pool_mod
    from oversim_tpu_torch.gateway import ExtFrame, inject_ext_batch
    out = chip_smoke.phase_service_reference(card)
    assert all(r["leaves_vs_cpu"] > 100 for r in out["runs"].values())

    @dataclasses.dataclass
    class PoolState:
        pool: object
        t_now: torch.Tensor

    mask = np.random.default_rng(3).random(8192) < 0.4
    frames = [ExtFrame(a=i + 1, b=i, c=2 * i, dst=i % 97)
              for i in range(3000)]
    got = []
    kernels.reset_launches()
    for dev in (card, torch.device("cpu")):
        pool = dataclasses.replace(pool_mod.empty(8192, 5, 16, dev),
                                   valid=torch.as_tensor(mask, device=dev))
        st, over = inject_ext_batch(PoolState(pool, torch.tensor(
            7, device=dev)), frames, 0)
        assert int(over) == 0
        got.append(interop.state_to_numpy(st))
    assert kernels.LAUNCHES["alloc_dest"] == 1
    assert chip_smoke.compare_states(*got) == 6


def test_epichord_and_inet_on_card_match_cpu(card):
    """EpiChord (iterative, semi-recursive, sparse) and the router
    topology (a reduced KademliaInet stack from an ini, Chord over ReaSE) at
    16 slots on the kernels against the CPU's torch ops; every run
    delivers and launches its kernels."""
    import chip_smoke
    for overlay in ("epichord", "inet"):
        out, launches = chip_smoke.phase_db_reference(card, overlay)
        for label in chip_smoke.DB_REF[overlay]:
            assert out[label]["leaves"] > 100 and out[label]["delivered"] > 0
        assert min(launches[k] for k in chip_smoke.DENSE_KERNELS) > 0
