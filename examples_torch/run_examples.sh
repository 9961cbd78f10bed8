#!/bin/sh
# Run every example of the port end to end on this machine: on the card,
# or on the CPU with EXAMPLE_PLATFORM=cpu. Prints each example's exit
# code and seconds; exits nonzero if any failed.
cd "$(dirname "$0")/.."
export PYTHONPATH="$PWD:$PYTHONPATH"

failed=0
for example in \
    distributed_fn_example \
    mnist_keras_example \
    linear_classifier_example \
    dlrm_example \
    mlflow_example \
    collective_allreduce_example \
    llama_lora_example \
    pytorch_example \
    evaluator_sidecar_example \
    ship_requirements_example \
    generate_example \
    "serving_example" \
    "serving_example --spec" \
    "serving_example --tp" \
    "serving_example fleet" \
    "ranking_example" \
    "ranking_example --tp"
do
    set -- $example
    name=$1
    shift
    echo "=== $example ==="
    start=$(date +%s)
    python3 "examples_torch/$name.py" "$@"
    rc=$?
    echo "=== $example: exit $rc, $(( $(date +%s) - start )) s ==="
    [ $rc -eq 0 ] || failed=1
done
if [ $failed -eq 0 ]; then
    echo "all examples passed"
else
    echo "some examples FAILED"
fi
exit $failed
