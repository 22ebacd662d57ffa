"""Launchers of the port: serving steps and the decode-arena server.

steps.py  -- make_prefill_step / make_decode_step (impl="auto": the CUDA
             kernel on the card)
serve.py  -- decode_state_graph, plan_decode_arena, pack/unpack/realize
             of the decode state, DecodeServer, run_server, and the CLI
             (``python -m repro_torch.launch.serve``)

The trainer, the mesh and the dry-run wait for ROADMAP A7/A8/A10.
"""
