"""The plain reference: the models, the tokenizer, the host noise and the
schedule in plain PyTorch and NumPy.  It imports neither JAX nor the JAX
package nor anything of the program."""
