"""How each kind of configuration builds the program under test (a
`jegal_torch.api.JegalEngine`), what it launches for a chunk of clips,
and a clip's model operations. One module a configuration's "system"."""
