"""Scale-out: the stream axis sharded over ranks (`mesh`), multi-process
serving with rank-local ingest (`distributed`), and a dry run of both
(`python -m spectrogram_tpu_torch.parallel.dryrun`)."""
