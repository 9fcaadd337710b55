"""rabit_tpu_torch.tracker — the wire protocol and the rendezvous tracker.

PyTorch-port counterpart of :mod:`rabit_tpu.tracker`: ``protocol`` (the
whole worker↔tracker wire) and ``tracker`` (the rendezvous core).  The
reference's directory, shard, replica and launchers wait for ROADMAP A8.
"""
