"""Models of the port: the generator, the text encoder, and reference-format
weight loading (`torch_import`)."""
