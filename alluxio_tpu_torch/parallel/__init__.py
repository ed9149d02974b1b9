"""Attention and mixture-of-experts pieces of the flagship model.

The port of ``alluxio_tpu/parallel``'s single-card functions. The parts
that run across cards (the mesh, ring attention's rotation, the sharded
expert layout, the pipeline, ``ici_store``) come with the NCCL slice.
"""
