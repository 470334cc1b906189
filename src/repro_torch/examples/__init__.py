"""The reference's examples on the port, each runnable as
``python -m repro_torch.examples.<name>`` (CUDA unless ``--device cpu``):

* ``quickstart``          -- train a smoke-scale qwen3 for a few steps, kill a
                             worker, recover with zero rollback;
* ``train_with_failover`` -- a ~64M-parameter model through a hardware failure,
                             then two failures with a transfer resumed from
                             partial chunks;
* ``elastic_rescale``     -- gemma-2b at smoke scale loses a worker with no
                             spare and shrinks its data-parallel degree.
"""
