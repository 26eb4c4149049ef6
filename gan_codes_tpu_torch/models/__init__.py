"""Models of the port: the generator, the discriminator, the text encoder,
and reference-format weight loading (`torch_import`)."""
