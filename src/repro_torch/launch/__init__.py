"""Launchers of the port: train and serving steps, the decode-arena
server and the trainer.

steps.py  -- make_train_step / make_optimizer, make_prefill_step /
             make_decode_step and the captured decode steps
             (impl="auto": the CUDA kernels on the card)
serve.py  -- decode_state_graph, plan_decode_arena, pack/unpack/realize
             of the decode state, DecodeServer, run_server, and the CLI
             (``python -m repro_torch.launch.serve``)
train.py  -- the training CLI (``python -m repro_torch.launch.train``)
mesh.py   -- the production and host meshes, ``rules_for_mesh``, and a
             process group of one rank in this process
dryrun.py -- every (arch x shape x mesh) cell's step on fake tensors over
             a fake 256/512-rank process group, counted (FLOPs, bytes,
             collectives, kernel launches, peak memory) into a roofline
             record a cell (``python -m repro_torch.launch.dryrun``)
"""
