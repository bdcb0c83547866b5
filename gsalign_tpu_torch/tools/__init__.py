"""Command-line tools of the port: the 3 Gb run (run_3gb) and the
per-stage profile of the pipeline (profile_pipeline). Each runs as
`python -m gsalign_tpu_torch.tools.<name>`."""
