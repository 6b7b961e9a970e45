"""Gather/scatter cost-model probes of the port on the H100.

The counterparts of the Pallas kernels of ``tools/probes/`` (TPU probes
that each answer one cost-model question about gathers and scatters)
and a driver that asks the same questions of the card:

    python -m lorads_torch.probes [--device cuda|cpu] [--small]
                                  [--only SECTION]

| module        | kernels (``csrc/``)                                  |
|---------------|------------------------------------------------------|
| ``onehot``    | P1 ``onehot_scatter``, P2 ``onehot_gather`` (``onehot_mma.cu``): sorted segment sum / sorted row gather as one-hot window products on the tensor cores |
| ``gather``    | P3 ``row_gather`` (``row_gather.cu``), P4 ``scatter_add`` (``scatter_add.cu``) |

No solver module imports this package: like ``tools/probes/`` in
``lorads_tpu``, it is an entry point of its own.
"""
