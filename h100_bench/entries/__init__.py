"""The calls a traffic mix's window makes, one module a mix's "entry":
`call(engine, mix, clips)` -> one result dict (or None) a clip, and
`chunks(mix, metas)` -> the padded chunks the program launches for a call
of clips with those shapes (the program's own buckets and batch ladder,
read from jegal_torch.data.bucketing)."""
