"""ctypes bindings to the native C++ layer (cpp/), built by the port itself."""
