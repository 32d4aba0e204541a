/* Parallel .npy batch loader.
 *
 * The channel-flow datasets are thousands of small per-step .npy files
 * (reference: libs/pde_data_loader.py loads them one np.load at a time).
 * This reads a batch of files concurrently with pthreads, each thread
 * pread()ing the raw payload (at a fixed header offset, validated by the
 * Python wrapper) straight into its slot of a preallocated arena.
 *
 * Build: cc -O2 -shared -fPIC -pthread fastloader.c -o libfastloader.so
 */
#include <fcntl.h>
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <unistd.h>

typedef struct {
    const char **paths;   /* file paths */
    char *out;            /* arena base */
    int64_t n_files;
    int64_t offset;       /* payload offset inside each file */
    int64_t nbytes;       /* payload bytes per file */
    int64_t next;         /* work index (atomic) */
    int64_t errors;       /* error count (atomic) */
} job_t;

static void *worker(void *arg) {
    job_t *job = (job_t *)arg;
    for (;;) {
        int64_t i = __sync_fetch_and_add(&job->next, 1);
        if (i >= job->n_files) break;
        int fd = open(job->paths[i], O_RDONLY);
        if (fd < 0) {
            __sync_fetch_and_add(&job->errors, 1);
            continue;
        }
        char *dst = job->out + i * job->nbytes;
        int64_t done = 0;
        while (done < job->nbytes) {
            ssize_t r = pread(fd, dst + done, job->nbytes - done,
                              job->offset + done);
            if (r <= 0) {
                __sync_fetch_and_add(&job->errors, 1);
                break;
            }
            done += r;
        }
        close(fd);
    }
    return NULL;
}

/* Returns 0 on success, number of failed files otherwise. */
int64_t load_npy_batch(const char **paths, int64_t n_files, int64_t offset,
                       int64_t nbytes, char *out, int n_threads) {
    job_t job = {paths, out, n_files, offset, nbytes, 0, 0};
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 64) n_threads = 64;
    pthread_t threads[64];
    for (int t = 0; t < n_threads; t++)
        pthread_create(&threads[t], NULL, worker, &job);
    for (int t = 0; t < n_threads; t++)
        pthread_join(threads[t], NULL);
    return job.errors;
}
